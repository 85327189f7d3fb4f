"""The least time of the region step, and the card's published peaks.

Frozen here so that the count stays the same whatever a later change does
to kernel B2: it is worked out from the regions' own sizes (their real
columns, their reads, their reads' events and (read, SNP site) entries),
never from the bucket's padding, the wire buffer or constants of B2's
current algorithm.  A column-by-column pileup would touch every aligned
base; the delta form needs only the events, so aligned bases are not
charged, and the floor holds for any algorithm.

Per pass, with C columns, R reads, E events, S entries:

    operations = 8 C + 2 R + 2 E + 2 S
        (a column's coverage step, its two votes and its het test; a read's
        start and end; an event's base into its haplotype's tally; an entry
        of a read's haplotype assignment)
    bytes = 3 C + 9 R + 5 E
        (the reference and two consensus tracks a column; a read's start,
        end and haplotype; an event's column and base)
    least seconds = max(operations / INT32_OPS_PER_S, bytes / HBM_BYTES_PER_S)
"""

from __future__ import annotations

# one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): 3.35 TB/s
# of HBM3; int32 on 64 lanes of each of 132 SMs at 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12


def region_step_least_s(counts: list[dict]) -> tuple[float, str]:
    """Least seconds of one pass's region steps, and what bounds it."""
    C = sum(c["columns"] for c in counts)
    R = sum(c["reads"] for c in counts)
    E = sum(c["events"] for c in counts)
    S = sum(c["site_entries"] for c in counts)
    t_ops = (8 * C + 2 * R + 2 * E + 2 * S) / INT32_OPS_PER_S
    t_bytes = (3 * C + 9 * R + 5 * E) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"
