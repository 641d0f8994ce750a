"""CLI entry points for the pipeline + dataset drivers.

Usage (mirrors the reference root scripts):
  python -m gs2mesh_torch.cli.run_pipeline single --dataset custom [flags...]
  python -m gs2mesh_torch.cli.run_pipeline dtu [flags...]
  python -m gs2mesh_torch.cli.run_pipeline tnt|evaluate_tnt|mobilebrick|mipnerf360

Every stage runs on the CUDA card (there is no device flag, as the JAX CLI
has none); the port's copy of gs2mesh_tpu cli/run_pipeline.py. GS training
on several cards (``--GS_devices N``) runs one process per card:

  torchrun --nproc-per-node N -m gs2mesh_torch.cli.run_pipeline single \
      --GS_devices N [flags...]
"""

from __future__ import annotations

import sys

from gs2mesh_torch.pipeline.config import PipelineArgs, make_parser


def _args_from_cli(dataset: str, argv):
    ns = make_parser(dataset).parse_args(argv)
    args = PipelineArgs.for_dataset(dataset)
    for k, v in vars(ns).items():
        if hasattr(args, k):
            setattr(args, k, v)
    if args.GS_devices > 1:
        from gs2mesh_torch.parallel.multihost import initialize

        initialize()                    # torchrun's environment
    return args


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "single":
        dataset = "custom"
        if "--dataset" in rest:
            i = rest.index("--dataset")
            dataset = rest[i + 1]
            rest = rest[:i] + rest[i + 2:]
        from gs2mesh_torch.pipeline.run_single import run_single

        path = run_single(_args_from_cli(dataset, rest))
        print(path)
    elif cmd == "dtu":
        from gs2mesh_torch.cli.drivers import run_DTU

        run_DTU(_args_from_cli("DTU", rest))
    elif cmd == "tnt":
        from gs2mesh_torch.cli.drivers import run_TNT

        run_TNT(_args_from_cli("TNT", rest))
    elif cmd == "evaluate_tnt":
        from gs2mesh_torch.cli.drivers import evaluate_TNT

        evaluate_TNT(_args_from_cli("TNT", rest))
    elif cmd == "mobilebrick":
        from gs2mesh_torch.cli.drivers import run_MobileBrick

        run_MobileBrick(_args_from_cli("MobileBrick", rest))
    elif cmd == "mipnerf360":
        from gs2mesh_torch.cli.drivers import run_MipNerf360

        run_MipNerf360(_args_from_cli("MipNerf360", rest))
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
