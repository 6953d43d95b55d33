"""The no-JAX guard compares whole top-level names."""
import subprocess
import sys

import pytest

from nvrbench import nojax


def test_top_level_names_compared_whole():
    assert nojax.top_level("instant_nvr_tpu_torch.models.inb") == "instant_nvr_tpu_torch"
    assert nojax.top_level("jax.numpy") == "jax"
    assert "instant_nvr_tpu_torch" not in nojax.FORBIDDEN


@pytest.mark.parametrize("name,refused", [("jax", True), ("jaxlib.xla_client", True),
                                          ("flax", True), ("instant_nvr_tpu", True),
                                          ("instant_nvr_tpu.models", True),
                                          ("instant_nvr_tpu_torch", False),
                                          ("jax_like_name", False)])
def test_hook_refuses_forbidden_names(name, refused):
    code = (f"import sys; from nvrbench import nojax; nojax.install()\n"
            f"try:\n    import {name}\nexcept nojax.ForbiddenImport:\n    sys.exit(7)\n"
            f"except ImportError:\n    sys.exit(0)\nsys.exit(0)")
    rc = subprocess.run([sys.executable, "-c", code], capture_output=True).returncode
    assert rc == (7 if refused else 0)


def test_loaded_lists_forbidden_modules():
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax');"
            "sys.modules['instant_nvr_tpu_torch_x'] = types.ModuleType('x');"
            "from nvrbench import nojax; print(nojax.loaded())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True).stdout
    assert out.strip() == "['jax']"
