"""Regenerate the synthetic fixture datasets under data/ with the port's
writer (port of ``tools/make_fixtures.py``, the same three recipes on
``datasets/fake_zju.write_fake_dataset``, whose files equal the JAX
package's writer's).

    python -m instant_nvr_tpu_torch.tools.make_fixtures [--only NAME]

- data/fake_zju   -- 3 views (2 train + 1 held-out), 4 frames, 512^2; used
                     by inb_fake / inb_fake_full (configs/inb).
- data/fake_zju5  -- 5 views (4 train + 1 held-out), 6 frames (frames 4-5
                     reserved for the novel-pose protocol), 512^2; used by
                     inb_fake_mv / inb_fake_mv_np.
- data/fake_zju_big (only with ``--only fake_zju_big``) -- 5 views x 100
                     frames at 1024^2 with SMPL's 6,890 vertices, trained
                     at ratio 0.5 as inb_377 is.

All are rendered with 4x4 (2x2 for the big one) supersampled ground truth
and the procedural texture.  Host numpy only: it runs no device code.
"""
from __future__ import annotations

import argparse

from ..datasets.fake_zju import write_fake_dataset


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.tools.make_fixtures")
    ap.add_argument("--only", choices=["fake_zju", "fake_zju5", "fake_zju_big"],
                    default=None)
    args = ap.parse_args(argv)
    if args.only in (None, "fake_zju"):
        print("writing data/fake_zju (3 views x 4 frames, 512^2) ...")
        write_fake_dataset("data/fake_zju", n_frames=4, n_views=3,
                           H=512, W=512, supersample=4, texture=True)
    if args.only in (None, "fake_zju5"):
        print("writing data/fake_zju5 (5 views x 6 frames, 512^2) ...")
        write_fake_dataset("data/fake_zju5", n_frames=6, n_views=5,
                           H=512, W=512, supersample=4, texture=True)
    if args.only == "fake_zju_big":
        # 1024^2 at ss=2 gives the same 4x4 ground-truth supersampling per
        # ratio-0.5 train pixel as ss=4 at 512^2; grid=32 makes the
        # per-frame blend-weight volumes large enough to matter
        print("writing data/fake_zju_big (5 views x 100 frames, 1024^2, "
              "6890 verts) ...")
        write_fake_dataset("data/fake_zju_big", n_frames=100, n_views=5,
                           n_verts=6890, H=1024, W=1024, supersample=2,
                           texture=True, grid=32)
    print("done")


if __name__ == "__main__":
    main()
