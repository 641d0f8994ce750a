"""Interactive viewer CLI: ``python -m gs2mesh_torch.cli.view model.ply``.

Standalone post-training inspection of a Gaussian-splat PLY in the browser,
rendered on the card by the port's rasterizer (the stand-in for the
reference's SIBR offline gaussian viewer). For LIVE mid-training viewing
with the original SIBR remote app, train with ``gs_tools train --gui``
(gs2mesh_torch.train.network_gui).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ply", help="point_cloud.ply from GS training")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (use 0.0.0.0 to expose externally)")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--pair-capacity", type=int, default=1 << 21)
    ap.add_argument("--white-background", action="store_true")
    return ap


def main(argv=None, device="cuda"):
    a = build_parser().parse_args(argv)

    from gs2mesh_torch.models.gaussians import GaussianModel
    from gs2mesh_torch.viewer import ViewerServer

    model = GaussianModel.load_ply(a.ply, max_sh_degree=a.sh_degree,
                                   device=device)
    ViewerServer(model, width=a.width, height=a.height,
                 pair_capacity=a.pair_capacity, port=a.port,
                 white_background=a.white_background, host=a.host,
                 device=device).serve()


if __name__ == "__main__":
    main()
