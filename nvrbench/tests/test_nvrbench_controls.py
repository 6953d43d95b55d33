"""The controls' lower precisions: ``bfloat16_encoding`` runs the
reference's hash-encoding lerp in bfloat16 (``common.control_precision``),
``float8_e4m3fn`` its MLP operands in float8; an unknown name is refused."""
import pytest
import torch

from nvrbench import common
from nvrbench.reference.ops import hashgrid


def test_lerp_dtype_is_set_and_restored():
    assert hashgrid.LERP_DTYPE == torch.float32
    with common.control_precision("bfloat16_encoding"):
        assert hashgrid.LERP_DTYPE == torch.bfloat16
    assert hashgrid.LERP_DTYPE == torch.float32
    with common.control_precision("float8_e4m3fn"):
        assert hashgrid.LERP_DTYPE == torch.float32
    with pytest.raises(RuntimeError):
        with common.control_precision("bfloat16_encoding"):
            raise RuntimeError("inside")
    assert hashgrid.LERP_DTYPE == torch.float32


def test_bfloat16_lerp_rounds_the_encoding_and_its_gradient():
    spec = hashgrid.make_hashgrid_spec(n_levels=4, n_features_per_level=2,
                                       log2_hashmap_size=10, base_resolution=4)
    gen = torch.Generator().manual_seed(5)
    tables = {k: (v * 100).requires_grad_()
              for k, v in hashgrid.hashgrid_init(spec, gen, "cpu").items()}
    pts = torch.rand((300, 3), generator=gen)
    unit = torch.tensor([[0.0] * 3, [1.0] * 3])

    def encode():
        for t in tables.values():
            t.grad = None
        out = hashgrid.hashgrid_encode(spec, tables, pts, unit)
        (out * torch.arange(out.numel()).reshape(out.shape).sin()).sum().backward()
        return out.detach(), [t.grad.clone() for t in tables.values() if t.grad is not None]

    f32, g32 = encode()
    with common.control_precision("bfloat16_encoding"):
        bf, gbf = encode()
    assert f32.dtype == bf.dtype == torch.float32
    gap = (bf - f32).abs().max() / f32.abs().max()
    assert 0 < gap < 2 ** -6
    assert g32 and any(not torch.equal(a, b) for a, b in zip(g32, gbf))


def test_reference_config_controls():
    with pytest.raises(ValueError):
        common.reference_config("nvrbench/tests/tiny_model.yaml", "int4")
    cfg = common.reference_config("nvrbench/tests/tiny_model.yaml", "float8_e4m3fn")
    assert cfg.mlp_dtype == "float8_e4m3fn"
    cfg = common.reference_config("nvrbench/tests/tiny_model.yaml", "bfloat16_encoding")
    assert cfg.mlp_dtype == "bfloat16"
