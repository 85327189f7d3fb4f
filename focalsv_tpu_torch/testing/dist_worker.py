"""Subprocess worker for REAL multi-process torch.distributed runs.

Each worker is one rank of a process group.  With every worker started,
`distributed.world_size() == process_count` holds inside run_target_mode,
so the production collective-gather branch (pipeline/main.py --
allgather_records over the group) executes for real, not the file merge.

Reference contrast: the reference's multi-node story is one SLURM job per
chromosome plus `cat | vcf-sort` (README.md:207-213); this worker is the
per-host entry of its replacement (SURVEY.md section 2.3).

Used by tests/test_torch_distributed.py and chip_smoke.py; also usable
manually, on the CPU over gloo or with one card a rank over NCCL:

    python -m focalsv_tpu_torch.testing.dist_worker --pid 0 --nprocs 2 \
        --port 12345 --bam r.bam --ref ref.fa --bed t.bed --out outdir \
        --device cpu --backend gloo
    CUDA_VISIBLE_DEVICES=0 python -m focalsv_tpu_torch.testing.dist_worker \
        --pid 0 --nprocs 2 --port 12345 ... --backend nccl
"""

from __future__ import annotations

import argparse
import os


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--port", required=True)
    ap.add_argument("--coordinator", default="localhost")
    ap.add_argument("--bam", required=True)
    ap.add_argument("--ref", required=True)
    ap.add_argument("--bed", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dtype", default="HIFI")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on a card, gloo on "
                         "the CPU)")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda or cuda:N (default: the port's own "
                         "choice, device.resolve_device)")
    args = ap.parse_args()

    from focalsv_tpu_torch.device import DEVICE_ENV
    if args.device:
        # before anything of the port resolves its device
        os.environ[DEVICE_ENV] = args.device

    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.parallel import distributed
    from focalsv_tpu_torch.pipeline.main import run_target_mode

    try:
        _, world = distributed.initialize(
            f"{args.coordinator}:{args.port}", args.nprocs, args.pid,
            backend=args.backend)
        if world != args.nprocs:
            raise RuntimeError(f"joined a group of {world}, expected "
                               f"{args.nprocs}")
        cfg = preset(args.dtype)
        path = run_target_mode(args.bam, args.ref, args.out, cfg,
                               target_bed=args.bed,
                               process_index=args.pid,
                               process_count=args.nprocs)
        print(f"FINAL:{path}", flush=True)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
