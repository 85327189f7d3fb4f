"""The plain reference that decides ``correct``.

The benchmark simulated the reads, so it knows what they carry: which
haplotype each read came from, every het SNP with its phase, both
haplotype sequences, and every SV with its kind, size and zygosity.  This
module reads what the program wrote for the user, in plain Python and
NumPy, and holds it to that truth, layer by layer:

- the region step's phasing: each region's ``region_phased.vcf`` (its het
  SNVs and their phase) and ``region_phased.bam`` (each read's HP and PS
  tags) against the SNPs and the haplotype each read came from;
- each region's consensus: ``HP1.fa`` and ``HP2.fa`` against the two true
  haplotypes, by their 21-mers;
- the chromosome's calls: the final VCF, after the FP filter, the
  redundancy removal and the refinement, against the SVs;
- in auto mode, step 0's BED (every SV inside a region).

It imports nothing of the program and takes nothing the program made but
those output files.  Each number is an error count or share, 0 when every
answer is right; the configuration file's ``limits`` name the numbers
that decide ``correct`` and how far each may go.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from focalbench import gen

K = 21
FLANK = 30_000     # past a region's ends, as far as its reads reach
_ENC = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _ENC[_c] = _i
    _ENC[_c + 32] = _i


# ---------------------------------------------------------------- truth


def left_align_del(ref: np.ndarray, p: int, n: int) -> int:
    while p > 1 and ref[p - 1] == ref[p + n - 1]:
        p -= 1
    return p


def left_align_ins(ref: np.ndarray, p: int, seq: np.ndarray) -> int:
    s = list(seq)
    while p > 1 and s[-1] == ref[p - 1]:
        s = s[-1:] + s[:-1]
        p -= 1
    return p


def truth_svs(truth: list[gen.SimSegment]) -> list[dict]:
    """Every SV on its chromosome, left-aligned as a VCF has it (POS is
    the 1-based anchor base, the base before the event)."""
    out = []
    for sim in truth:
        for sv in sim.svs:
            if sv.kind == "DEL":
                p = left_align_del(sim.ref, sv.pos, sv.length)
            else:
                p = left_align_ins(sim.ref, sv.pos, sv.seq)
            out.append(dict(chrom=sim.seg.chrom, pos=p + sim.seg.offset,
                            end=sim.seg.offset + sv.pos + (
                                sv.length if sv.kind == "DEL" else 0),
                            kind=sv.kind, length=sv.length, gt=sv.gt))
    return out


# ---------------------------------------------------------------- files


def read_vcf(path: str) -> list[dict]:
    recs = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            c = line.rstrip("\n").split("\t")
            info = dict(kv.split("=", 1) if "=" in kv else (kv, True)
                        for kv in c[7].split(";"))
            recs.append(dict(chrom=c[0], pos=int(c[1]), ref=c[3], alt=c[4],
                             info=info, gt=c[9] if len(c) > 9 else "./."))
    return recs


def read_fasta(path: str) -> list[np.ndarray]:
    seqs, cur = [], []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if cur:
                    seqs.append(b"".join(cur))
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        seqs.append(b"".join(cur))
    return [_ENC[np.frombuffer(s, np.uint8)] for s in seqs]


def bam_tags(path: str) -> list[tuple[str, int, int]]:
    """(read name, HP, PS) of every record of a BAM (0 for a missing
    tag), by a plain walk of the BGZF blocks and the record layout."""
    raw = open(path, "rb").read()
    data, off = bytearray(), 0
    while off < len(raw):
        xlen = struct.unpack_from("<H", raw, off + 10)[0]
        bsize = struct.unpack_from("<H", raw, off + 16)[0] + 1
        data += zlib.decompress(raw[off + 12 + xlen:off + bsize - 8], -15)
        off += bsize
    l_text = struct.unpack_from("<i", data, 4)[0]
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", data, p)[0]
    p += 4
    for _ in range(n_ref):
        p += 8 + struct.unpack_from("<i", data, p)[0]
    out = []
    while p + 4 <= len(data):
        size = struct.unpack_from("<i", data, p)[0]
        end = p + 4 + size
        l_name, _, _, n_cig, _, l_seq = struct.unpack_from(
            "<BBHHHi", data, p + 12)
        name = bytes(data[p + 36:p + 36 + l_name - 1]).decode()
        q = p + 36 + l_name + 4 * n_cig + (l_seq + 1) // 2 + l_seq
        tags = {}
        while q < end:
            tag, typ = bytes(data[q:q + 2]).decode(), chr(data[q + 2])
            q += 3
            if typ in "cCsSiI":
                fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
                       "I": "<I"}[typ]
                tags[tag] = struct.unpack_from(fmt, data, q)[0]
                q += struct.calcsize(fmt)
            elif typ == "A":
                q += 1
            elif typ == "f":
                q += 4
            elif typ in "ZH":
                q = data.index(0, q) + 1
            elif typ == "B":
                sub, n = chr(data[q]), struct.unpack_from("<i", data, q + 1)[0]
                q += 5 + n * struct.calcsize("<" + sub)
            else:
                raise ValueError(f"{path}: unknown tag type {typ!r}")
        out.append((name, tags.get("HP", 0), tags.get("PS", 0)))
        p = end
    return out


# ---------------------------------------------------------------- k-mers


def kmers(codes: np.ndarray) -> np.ndarray:
    """The distinct 21-mers of a sequence as integers (2 bits a base);
    windows that hold a base other than A, C, G, T are left out."""
    codes = np.asarray(codes, np.uint8)
    n = len(codes) - K + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    bad = codes > 3
    c = np.where(bad, 0, codes).astype(np.int64)
    vals = np.zeros(n, np.int64)
    for j in range(K):
        vals = (vals << 2) | c[j:j + n]
    nbad = np.concatenate([[0], np.cumsum(bad)])
    return np.unique(vals[nbad[K:] == nbad[:n]])


# ---------------------------------------------------------------- checks


def check_calls(recs: list[dict], truth: list[dict], pos_tol: int = 200,
                min_size_sim: float = 0.7) -> dict:
    """Final calls against the SVs, one to one: a call matches an SV of its
    kind within ``pos_tol`` of its position whose sizes agree to
    ``min_size_sim``, the nearest first."""
    calls = [dict(chrom=r["chrom"], pos=r["pos"],
                  kind=str(r["info"].get("SVTYPE", "")),
                  length=abs(int(r["info"].get("SVLEN",
                                               len(r["alt"]) - len(r["ref"])))),
                  gt=r["gt"].replace("|", "/")) for r in recs]
    pairs = []
    for i, c in enumerate(calls):
        for j, t in enumerate(truth):
            if c["chrom"] != t["chrom"] or c["kind"] != t["kind"]:
                continue
            d = abs(c["pos"] - t["pos"])
            sim = min(c["length"], t["length"]) / max(c["length"],
                                                       t["length"], 1)
            if d <= pos_tol and sim >= min_size_sim:
                pairs.append((d, i, j))
    used_c, used_t, pos_gap, len_gap, gt_wrong = set(), set(), 0, 0, 0
    for d, i, j in sorted(pairs):
        if i in used_c or j in used_t:
            continue
        used_c.add(i)
        used_t.add(j)
        pos_gap = max(pos_gap, d)
        len_gap = max(len_gap, abs(calls[i]["length"] - truth[j]["length"]))
        gt_wrong += calls[i]["gt"] != truth[j]["gt"]
    return dict(sv_missed=len(truth) - len(used_t),
                sv_false=len(calls) - len(used_c), gt_wrong=gt_wrong,
                sv_pos_gap=pos_gap, sv_len_gap=len_gap)


def check_bed(bed_text: str, truth: list[dict]) -> dict:
    """Step 0's regions (the BED's text): every SV's span has to lie
    inside one."""
    regs: dict[str, list[tuple[int, int]]] = {}
    for line in bed_text.splitlines():
        c = line.split()
        if len(c) >= 3:
            regs.setdefault(c[0], []).append((int(c[1]), int(c[2])))
    missed = sum(not any(s <= t["pos"] and t["end"] <= e
                         for s, e in regs.get(t["chrom"], ()))
                 for t in truth)
    return dict(bed_missed=missed)


def _regions_of(sim: gen.SimSegment, region_dirs: dict) -> list:
    """The program's region directories that lie on this segment, with the
    interval each names (Region_<chrom>_S<start>_E<end>)."""
    lo, hi = sim.seg.offset, sim.seg.offset + sim.seg.width
    return [(s, e, d) for (c, s, e), d in region_dirs.items()
            if c == sim.seg.chrom and lo <= s and e <= hi]


def _phase(sim, s, e, d, acc):
    """One region: its SNVs and their phase, and its reads' HP tags."""
    off = sim.seg.offset
    at = sim.snps[:, 0] + off
    snps = sim.snps[(at >= s) & (at < e)]
    truth = {int(p) + off + 1: (int(a), int(h)) for p, _, a, h in snps}
    vcf = os.path.join(d, "region_phased.vcf")
    called = read_vcf(vcf) if os.path.exists(vcf) else []
    found, blocks = set(), {}
    for r in called:
        t = truth.get(r["pos"])
        if t is None or len(r["alt"]) != 1 or _ENC[ord(r["alt"])] != t[0]:
            acc["snv_false"] += 1
            continue
        found.add(r["pos"])
        gt = r["gt"].split("|")
        if len(gt) == 2 and "PS" in r["info"]:
            # the haplotype the alt allele sits on, against the truth's
            blocks.setdefault(r["info"]["PS"], []).append(
                (r["pos"], int(gt[0] != "1") == t[1]))
    acc["snv_missed"] += len(truth) - len(found)
    acc["snvs"] += len(truth)
    for sites in blocks.values():
        same = [x for _, x in sorted(sites)]
        acc["switches"] += sum(a != b for a, b in zip(same, same[1:]))
    bam = os.path.join(d, "region_phased.bam")
    tags = bam_tags(bam) if os.path.exists(bam) else []
    n_reads = sim.reads_in(s, e)
    acc["reads"] += n_reads
    by_ps: dict[int, list[int]] = {}
    for name, hp, ps in tags:
        if hp > 0:
            true_h = int(name.rsplit("_h", 1)[1]) - 1
            by_ps.setdefault(ps, []).append(int(hp - 1 == true_h))
    tagged = sum(len(v) for v in by_ps.values())
    acc["untagged"] += max(n_reads - tagged, 0)
    acc["misphased"] += sum(min(sum(v), len(v) - sum(v))
                            for v in by_ps.values())


def _contigs(sim, s, e, d, acc):
    """One region: its two contigs' 21-mers against the haplotypes'."""
    off = sim.seg.offset
    haps, near = [], []
    for h in range(2):
        # the haplotype's stretch between the region's ends, and with the
        # flanks its reads reach (a contig may run past the region's ends)
        hs, segs = sim.haps[h], sim.hap_segments[h]
        a = _ref_to_hap(segs, s - off)
        b = _ref_to_hap(segs, e - off)
        haps.append(kmers(hs[a:b]))
        near.append(kmers(hs[max(0, a - FLANK):b + FLANK]))
    whole = np.union1d(near[0], near[1])
    only = [np.setdiff1d(haps[0], haps[1]), np.setdiff1d(haps[1], haps[0])]
    got = []
    for hp in (1, 2):
        fa = os.path.join(d, f"HP{hp}.fa")
        seqs = read_fasta(fa) if os.path.exists(fa) else []
        got.append(np.unique(np.concatenate([kmers(x) for x in seqs]))
                   if seqs else np.zeros(0, np.int64))
    for g in got:
        acc["contig_kmers"] += len(g)
        acc["contig_kmers_wrong"] += int((~_member(whole, g)).sum())
        # the haplotype this contig stands for: the one whose own k-mers
        # it holds more of; the other's are a mix-up
        own = [len(np.intersect1d(g, o)) for o in only]
        acc["hap_kmers"] += max(own)
        acc["hap_kmers_mixed"] += min(own)
    # each haplotype's k-mers that neither contig holds
    allgot = np.union1d(got[0], got[1])
    acc["true_kmers"] += len(haps[0]) + len(haps[1])
    acc["true_kmers_missed"] += (len(np.setdiff1d(haps[0], allgot))
                                 + len(np.setdiff1d(haps[1], allgot)))


def _member(sorted_set: np.ndarray, x: np.ndarray) -> np.ndarray:
    i = np.searchsorted(sorted_set, x)
    i[i == len(sorted_set)] = 0
    return sorted_set[i] == x if len(sorted_set) else np.zeros(len(x), bool)


def _ref_to_hap(segs: list, r: int) -> int:
    for hs, he, rs, kind in segs:
        if kind == "M" and rs <= r < rs + (he - hs):
            return hs + (r - rs)
    return segs[-1][1] if r >= segs[-1][2] else 0


# the files upstream's layout has in every region's directory
REGION_FILES = ("region_phased.bam", "region_phased.vcf", "HP1.fa", "HP2.fa")


def regions_written(regions_root: dict) -> int:
    """Region directories that hold every file of ``REGION_FILES``, none
    of them empty.  ``regions_root``: {chrom: its ``regions/``}."""
    n = 0
    for root in regions_root.values():
        for name in os.listdir(root) if os.path.isdir(root) else ():
            d = os.path.join(root, name)
            n += all(os.path.isfile(os.path.join(d, f))
                     and os.path.getsize(os.path.join(d, f)) > 0
                     for f in REGION_FILES)
    return n


def check_regions(truth: list[gen.SimSegment], regions_root: dict,
                  sample: int | None = None, seed: int = 0) -> dict:
    """The region directories the run wrote, against the truth of the
    segment each lies on: all of them are counted, ``sample`` of them (all
    where None), drawn from ``seed``, are read.  ``regions_root``: {chrom:
    the chromosome's ``regions/`` directory}."""
    dirs = {}
    for chrom, root in regions_root.items():
        for n in os.listdir(root) if os.path.isdir(root) else ():
            c, se = n[len("Region_"):].rsplit("_S", 1)
            st, en = se.split("_E")
            dirs[(c, int(st), int(en))] = os.path.join(root, n)
    on = [(sim, r) for sim in truth for r in _regions_of(sim, dirs)]
    if sample is not None and sample < len(on):
        pick = np.random.default_rng(seed).choice(len(on), sample,
                                                  replace=False)
        chosen = [on[i] for i in sorted(pick)]
    else:
        chosen = on
    acc = dict.fromkeys(("snv_false", "snv_missed", "snvs", "switches",
                         "reads", "untagged", "misphased", "contig_kmers",
                         "contig_kmers_wrong", "hap_kmers", "hap_kmers_mixed",
                         "true_kmers", "true_kmers_missed"), 0)
    for sim, (s, e, d) in chosen:
        _phase(sim, s, e, d, acc)
        _contigs(sim, s, e, d, acc)
    n = len(on)
    pct = lambda a, b: 100.0 * a / b if b else 100.0  # noqa: E731
    return dict(
        regions_checked=n,
        snv_missed_pct=pct(acc["snv_missed"], acc["snvs"]),
        snv_false=acc["snv_false"],
        phase_switches=acc["switches"],
        reads_untagged_pct=pct(acc["untagged"], acc["reads"]),
        reads_misphased_pct=pct(acc["misphased"], acc["reads"]),
        contig_kmers_wrong_ppm=(1e6 * acc["contig_kmers_wrong"]
                                / acc["contig_kmers"]
                                if acc["contig_kmers"] else 1e6),
        contig_hap_mixed_pct=pct(acc["hap_kmers_mixed"],
                                 acc["hap_kmers"] + acc["hap_kmers_mixed"]),
        hap_kmers_missed_pct=pct(acc["true_kmers_missed"],
                                 acc["true_kmers"]))
