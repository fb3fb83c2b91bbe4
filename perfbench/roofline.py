"""The least time a kernel entry's work can take on the card, from shapes.

Each function counts the work of one call of an entry of
multigridbarrier_tpu_torch/runtime/cuda_kernels.py as the function
defines it, not as its kernel happens to do it: each input byte read once,
each output byte written once (outputs updated in place read and written),
and the arithmetic of the plain version.  Where the work depends on the
data, what these inputs need: a gather reads at most the rows it names, a
list sum the sources its list holds.  bound(bytes, flops, device) is the
larger of bytes over peak bandwidth and flops over peak float64 rate.

PEAKS holds published data-sheet rates, SXM part, dense, without sparsity.
"""

from __future__ import annotations

# device name -> (bytes/s, float64 flop/s)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
}

I32 = 4


def bound(nbytes: float, flops: float, device: str):
    """Seconds, or None for a card the table does not know."""
    peak = PEAKS.get(device)
    if peak is None:
        return None
    return max(nbytes / peak[0], flops / peak[1])


def he_assemble(nelem, nq, k, C, es, weighted):
    """He = P^T W P per element; W = F2 * w formed from F2 and w when weighted."""
    pts = nelem * nq
    nbytes = es * (nelem * nq * k * C + pts * k * k + (pts if weighted else 0) + nelem * C * C)
    flops = 2 * pts * (k * k * C + k * C * C) + (pts * k * k if weighted else 0)
    return nbytes, flops


def element_matvec(nelem, C, nl, nf, m, es):
    """He[e] @ v[idx[e]] per element, slot by slot."""
    return es * (nelem * C * C + nf * (m + 1) + nelem * C) + I32 * nelem * nl, 2 * nelem * C * C


def hvp(nelem, C, nl, nf, m, width, es):
    """H v: element products gathered through idx and summed through the table."""
    nbytes = es * (nelem * C * C + 2 * nf * (m + 1)) + I32 * (nelem * nl + (m + 1) * width)
    return nbytes, 2 * nelem * C * C + nelem * C


def table_sum(rows, f, m, width, es):
    """out[a] = sum of the src rows the table lists for node a."""
    return es * (rows * f + (m + 1) * f) + I32 * (m + 1) * width, rows * f


def segment_sum(rows, f, n_list, nseg, es, listed, add):
    """Segment sums over a list (or src in order); add: into listed dst rows in place."""
    nbytes = es * min(rows, n_list) * f + I32 * (nseg + 1) + es * nseg * f * (2 if add else 1)
    if listed:
        nbytes += I32 * n_list
    if add:
        nbytes += I32 * nseg
    return nbytes, n_list * f + (nseg * f if add else 0)


def row_gather(n_idx, n, lanes, es):
    """out = v[idx] along rows."""
    return I32 * n_idx + es * lanes * (min(n_idx, n) + n_idx), 0


def take_along_rows(rows, lanes, n, es):
    """out[r, l] = v[idx[r, l], l]."""
    return I32 * rows * lanes + es * lanes * (min(rows, n) + rows), 0
