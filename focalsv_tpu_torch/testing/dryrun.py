"""Entry points of a dry run: a single-device step, and the multi-device
path end to end on a mesh.

    FOCALSV_TORCH_DEVICE=cpu python -c "from focalsv_tpu_torch.testing \
        import dryrun; dryrun.dryrun_multichip(2)"

Without the variable the mesh is made of the cards present; ``devices``
names the shards' devices outright (two logical shards of one card:
``devices=["cuda:0", "cuda:0"]``).
"""

import functools

import numpy as np


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dry run failed: {what}")


def entry():
    """(fn, example_args): forward step of the flagship compute -- the
    batched banded affine alignment over a region tile batch, kernel B1 on
    a card and its plain version on the CPU.  The example arguments are
    tensors on the port's device (device.resolve_device)."""
    from focalsv_tpu_torch.device import resolve_device
    from focalsv_tpu_torch.ops.align import banded_align, to_device

    B, LQ, LT, BAND = 8, 1024, 1024, 128
    rng = np.random.default_rng(0)
    t = rng.integers(0, 4, (B, LT)).astype(np.uint8)
    q = t.copy()
    q[:, 400:420] = (q[:, 400:420] + 1) % 4   # mismatches to exercise paths
    q_len = np.full(B, LQ - 64, np.int32)
    t_len = np.full(B, LT, np.int32)
    d_lo = ((t_len - q_len) // 2 - BAND // 2).astype(np.int32)

    fn = functools.partial(banded_align, band=BAND, store_dirs=True)
    return fn, tuple(to_device(resolve_device(), q, q_len, t, t_len, d_lo))


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Execute the full sharded region step on an n-shard mesh:
    region-batch data parallelism across (1) the PRODUCTION chromosome
    step (process_chromosome in device mode -- tile build -> sharded
    region step -> host finish -> FP filter/dedup/refine), (2) the packed
    row entry vs the unpacked dense entry bit-for-bit, and (3) banded
    alignment DP with the gathered cross-region candidate table."""
    import os
    import tempfile
    import time

    from focalsv_tpu_torch.parallel import mesh as pmesh
    from focalsv_tpu_torch.parallel.region_step import (
        BLOCK, flat_layout, pack_row_tile, sharded_phase_consensus,
        sharded_phase_consensus_rows_packed, unflatten_result)

    mesh = pmesh.make_mesh(n_devices, devices=devices)
    rng = np.random.default_rng(0)

    # stage 1: the PRODUCTION chromosome step on the mesh.  process_chromosome
    # in device mode builds the tiles, dispatches the sharded region step
    # over the mesh, and finishes on host -- the code path the CLI runs on
    # a machine with several cards.
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.io import bam as bamio
    from focalsv_tpu_torch.io.bed import Region
    from focalsv_tpu_torch.io.fasta import FastaFile, write_fasta
    from focalsv_tpu_torch.pipeline.main import process_chromosome
    from focalsv_tpu_torch.testing import simulate as sim

    with tempfile.TemporaryDirectory(prefix="focalsv_dryrun_") as tmp:
        svs = [sim.SimSV("DEL", 4_000, 120, "1/1")]
        region = sim.simulate_region(seed=11, ref_len=8_192, coverage=12,
                                     n_snps=12, svs=svs, chrom="chr21")
        bam_path = os.path.join(tmp, "dry.bam")
        sim.write_region_bam(region, bam_path)
        ref_path = os.path.join(tmp, "ref.fa")
        write_fasta(ref_path, [("chr21", region.ref)])
        bam = bamio.ensure_indexed(bam_path)
        fasta = FastaFile.load(ref_path)
        cfg = preset("HIFI")
        regions = [Region("chr21", 0, 8_192)] * mesh.size  # fills the mesh
        cres = process_chromosome(bam, fasta, "chr21", regions, cfg,
                                  num_workers=2, mesh=mesh)
        _check(any(r.svtype == "DEL" for r in cres.records),
               "production mesh run produced no DEL call")

    # stage 2: packed row entry vs the unpacked dense entry
    # (row starts are BLOCK-quantized: pack at start % BLOCK, ship start //
    # BLOCK -- the production build_tile layout)
    G, R, L, W = mesh.size * 2, 8, 256, 128
    Wp = 2 * BLOCK   # row span + max in-block offset, BLOCK-multiple
    mat = np.full((G, R, L), 255, np.uint8)
    qstarts = np.zeros((G, R), np.int32)
    rows_packed = np.zeros((G, R, Wp // 2), np.uint8)
    for g in range(G):
        rows = []
        offs = []
        for r in range(R):
            st = int(rng.integers(0, L - W + 1))
            row = rng.integers(0, 4, W).astype(np.uint8)
            row[::7] = 255
            mat[g, r, st : st + W] = row
            qstarts[g, r] = st // BLOCK
            offs.append(st % BLOCK)
            rows.append(row)
        rows_packed[g] = pack_row_tile(rows, Wp, offsets=offs)
    valid = np.ones((G, R), bool)
    out = sharded_phase_consensus(mat, valid, mesh, max_sites=8, mec_iters=4)
    # wall time of the sharded call, copies to and from the host included
    # (three passes after the first: no pass should stand out)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sharded_phase_consensus(mat, valid, mesh, max_sites=8, mec_iters=4)
        walls.append(time.perf_counter() - t0)
    w = sorted(walls)[1]
    print(f"# dryrun sharded dispatch: {w * 1e3:.1f} ms for {G} regions on "
          f"{mesh!r} (host clock), passes "
          f"{[round(x * 1e3, 1) for x in walls]}")
    site_pos, n_sites, A, hp, sym, cov = (x.numpy() for x in out)
    _check(hp.shape == (G, R) and sym.shape == (G, 2, L), "output shapes")
    bufs = sharded_phase_consensus_rows_packed(
        rows_packed, qstarts, valid, mesh, L=L, W=Wp, max_sites=8,
        mec_iters=4).numpy()
    _check(bufs.shape == (G, flat_layout(R, L, 8)["__total__"][1]),
           "flat result shape")
    # packed-row and unpacked dense entries agree bit-for-bit
    for g in range(G):
        sp, ns, hp2, sym2, cov2, *_site = unflatten_result(bufs[g], R, L, 8)
        _check(np.array_equal(hp2, hp[g]) and np.array_equal(sym2, sym[g])
               and np.array_equal(cov2, cov[g]),
               f"packed rows against dense tiles, region {g}")
    # stage 3: sharded banded DP + the gathered candidate table
    B, LQ, LT = mesh.size * 2, 256, 256
    t = rng.integers(0, 4, (B, LT)).astype(np.uint8)
    q = t.copy()
    q[:, 64:70] = (q[:, 64:70] + 1) % 4
    q_len = np.full(B, LQ - 32, np.int32)
    t_len = np.full(B, LT, np.int32)
    d_lo = ((t_len - q_len) // 2 - 64).astype(np.int32)
    scores, cand, global_cand = pmesh.sharded_sv_candidate_step(
        q, q_len, t, t_len, d_lo, mesh=mesh)
    _check(len(global_cand) == mesh.size
           and all(c.shape == (B, 3) and bool((c.cpu() == cand.cpu()).all())
                   for c in global_cand), "every shard's candidate table")
    _check(bool((cand[:, 0] == scores).all()), "candidate scores")
