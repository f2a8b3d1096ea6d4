"""SPC5 block-sparse matrix formats without zero padding (Bramas & Kus 2018).

A numpy copy of the reference package's ``repro.core.formats``, cut to what
the port's paths use: CSR, the beta(r,c) format, the CSR -> beta(r,c)
conversion and its inverse (:func:`spc5_to_coo`, :func:`spc5_to_csr`), the
two chunked device layouts and the panel layout's chunk count the reorder
pass scores with (:func:`count_panel_chunks`), the descriptor lowering's
byte models and tables (:func:`chunk_descriptors`) and the beta(r,c)_test
split (:func:`split_singletons`). The builders are
kept line for line, so both packages produce the same bytes from the same
matrix (``tests/test_torch_formats.py`` holds them to that).

The beta(r,c) format (paper fig. 2):
  * blocks are r-row aligned (top row of a block is a multiple of r) but may
    start at ANY column;
  * ``values`` holds ONLY the nonzeros (no padding), in block order and
    row-major inside each block;
  * ``block_colidx`` holds the leftmost column of each block;
  * ``block_rowptr[i]`` is the index of the first block of row-interval i
    (interval = rows [i*r, (i+1)*r));
  * ``block_masks`` holds one r*c-bit mask per block; bit (lr*c + j) set means
    position (row lr, col j) inside the block is a nonzero. r*c reaches 32
    for 4x8 and 8x4, so bit 31 is used.

Two device-facing layouts are derived from :class:`SPC5Matrix`:

  * :func:`to_chunked` -> :class:`SPC5Chunked`: flat chunks of CB blocks for
    the whole-vector kernels (each chunk reads all of x and scatters into
    all of y);
  * :func:`to_panels` -> :class:`SPC5Panels`: row-panel-tiled chunks, each
    touching one ``(pr,)`` slice of y and one ``xw``-wide window of x.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

SUPPORTED_BLOCKS: Tuple[Tuple[int, int], ...] = (
    (1, 4), (1, 8), (2, 4), (2, 8), (4, 4), (4, 8), (8, 4),
)

#: Canonical value-storage dtypes of the reference: f32, bf16 and int8 (with
#: one f32 scale a chunk), every product accumulating in f32.
VDTYPES: Tuple[str, ...] = ("f32", "bf16", "int8")

_VDTYPE_ALIASES = {
    "f32": "f32", "float32": "f32", "fp32": "f32",
    "bf16": "bf16", "bfloat16": "bf16",
    "int8": "int8", "i8": "int8", "s8": "int8",
}


def canonical_vdtype(name: str) -> str:
    """Normalise a value-dtype name to one of :data:`VDTYPES` (the sentinels
    ``""`` and ``"auto"`` pass through unchanged)."""
    if name in ("", "auto"):
        return name
    key = str(name).strip().lower()
    if key not in _VDTYPE_ALIASES:
        raise ValueError(f"unknown vdtype {name!r}; expected one of "
                         f"{VDTYPES + ('auto', '')}")
    return _VDTYPE_ALIASES[key]


#: The host store of bf16 values: their 16-bit patterns. numpy has no
#: bfloat16 and the reference's ``ml_dtypes`` is not a dependency of the
#: port, so bf16 arrays live on the host as ``uint16`` (no other array of
#: the port is ``uint16``) and become ``torch.bfloat16`` on the device
#: (:func:`repro_torch.core.ref_spmv.to_tensor`).
BF16_HOST = np.dtype(np.uint16)


def value_dtype(vdtype: str) -> np.dtype:
    """The host dtype of a canonical vdtype's stored values: float32,
    :data:`BF16_HOST` (bf16 bit patterns) or int8 (the reference's
    ``value_dtype``, with ``ml_dtypes.bfloat16`` there)."""
    vd = canonical_vdtype(vdtype)
    if vd == "bf16":
        return BF16_HOST
    if vd == "int8":
        return np.dtype(np.int8)
    return np.dtype(np.float32)


def value_itemsize(vdtype: str) -> int:
    """Bytes per stored value for a canonical vdtype ('' -> f32's 4)."""
    if vdtype in ("", "auto", "f32"):
        return 4
    return int(value_dtype(vdtype).itemsize)


def bf16_bits(values: np.ndarray) -> np.ndarray:
    """The bf16 bit patterns (``uint16``) of ``values``: cast to float32 by
    numpy, then rounded to bfloat16 by torch (to nearest, ties to even), bit
    for bit what ``values.astype(ml_dtypes.bfloat16)`` stores, which also
    rounds a float64 through float32. A NaN keeps its sign and becomes the
    quiet NaN 0x7fc0 (0xffc0 negative), whatever torch's cast makes of it
    on the host at hand (``ml_dtypes`` keeps more of the payload)."""
    import torch                        # the cast only; formats stays numpy
    v32 = np.ascontiguousarray(np.asarray(values, dtype=np.float32))
    bits = torch.from_numpy(v32).to(torch.bfloat16).view(torch.int16)
    bits = bits.numpy().view(BF16_HOST).copy()
    nan = np.isnan(v32)
    bits[nan] = np.where(np.signbit(v32[nan]), 0xffc0, 0x7fc0)
    return bits


def quantize_chunk_values(values: np.ndarray, chunk_vbase: np.ndarray,
                          chunk_mask: np.ndarray, vdtype: str
                          ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Quantise a chunked or panelled packed values array to ``vdtype``.

    Returns ``(qvalues, scales)``; ``scales`` is None except for int8, which
    gets one symmetric f32 scale a chunk: ``absmax / 127`` (in float64, then
    cast to float32) over the chunk's OWN nonzeros, ``values[vbase : vbase +
    popcount(masks)]``, not its vmax window, which reaches into the next
    chunk's values. A chunk with no values, or only zeros, gets scale 1.0.
    Each value is divided by its chunk's scale in float32, rounded half to
    even and clipped to [-127, 127]; values of no chunk (padding) stay 0.
    Any leading chunk shape works (flat or panel-tiled): ``chunk_vbase`` and
    the per-chunk mask rows are raveled in step, and ``scales`` has
    ``chunk_vbase``'s shape. The reference's function
    (``repro.core.formats``) with its per-chunk loop vectorised, byte for
    byte, and bf16 as :func:`bf16_bits`."""
    vd = canonical_vdtype(vdtype)
    if vd in ("", "auto", "f32"):
        return values.astype(np.float32), None
    if vd == "bf16":
        return bf16_bits(values), None
    shape = np.asarray(chunk_vbase).shape
    vbase = np.asarray(chunk_vbase).ravel().astype(np.int64)
    nnz = popcount_u32(np.asarray(chunk_mask).reshape(vbase.shape[0], -1)
                       ).sum(axis=1).astype(np.int64)
    scales = np.ones(vbase.shape[0], dtype=np.float32)
    q = np.zeros(values.shape[0], dtype=np.int8)
    live = np.flatnonzero(nnz > 0)
    if live.size:
        lens = nnz[live]
        first = np.cumsum(lens) - lens      # each live chunk's first element
        chunk = np.repeat(live, lens)
        pos = (np.repeat(vbase[live] - first, lens)
               + np.arange(int(lens.sum()), dtype=np.int64))
        v32 = values[pos].astype(np.float32)
        absmax = np.maximum.reduceat(np.abs(v32), first)
        big = absmax > 0.0                  # NaN: False, as in the reference
        scales[live[big]] = (absmax[big].astype(np.float64)
                             / 127.0).astype(np.float32)
        q[pos] = np.clip(np.round(v32 / scales[chunk]), -127,
                         127).astype(np.int8)
    return q, scales.reshape(shape)


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row, the de-facto baseline format (paper fig. 1)."""

    shape: Tuple[int, int]
    rowptr: np.ndarray  # int32/int64, (nrows + 1,)
    colidx: np.ndarray  # int32, (nnz,)
    values: np.ndarray  # float, (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.values.dtype)
        for i in range(self.nrows):
            lo, hi = int(self.rowptr[i]), int(self.rowptr[i + 1])
            out[i, self.colidx[lo:hi]] = self.values[lo:hi]
        return out

    def occupancy_bytes(self, s_int: int = 4) -> int:
        """Paper eq. (3) on this instance: O_CSR = NNZ*S_f + N_rows*S_i +
        NNZ*S_i, the row pointer counted with its last entry."""
        s_float = self.values.dtype.itemsize
        return self.nnz * s_float + (self.nrows + 1) * s_int + self.nnz * s_int


@dataclasses.dataclass
class SPC5Matrix:
    """The paper's beta(r, c) block format with bitmasks, no zero padding."""

    shape: Tuple[int, int]
    r: int
    c: int
    block_rowptr: np.ndarray   # int64, (ceil(nrows/r) + 1,)
    block_colidx: np.ndarray   # int32, (nblocks,)
    block_masks: np.ndarray    # uint32, (nblocks,)  (r*c <= 32 bits used)
    block_voffset: np.ndarray  # int64, (nblocks,)  exclusive prefix popcount
    values: np.ndarray         # float, (nnz,) -- exactly nnz, no padding

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def nblocks(self) -> int:
        return int(self.block_colidx.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def avg_nnz_per_block(self) -> float:
        """Avg(r, c) = NNZ / N_blocks(r, c) -- the paper's selection feature."""
        return self.nnz / max(self.nblocks, 1)

    @property
    def fill_ratio(self) -> float:
        """Average block fill in [0, 1] (paper tables 1-2 percentages)."""
        return self.avg_nnz_per_block / (self.r * self.c)

    def occupancy_bytes(self, s_int: int = 4) -> int:
        """Paper eqs. (1)/(2) on this instance: the values, the interval
        pointer, one column index a block and each block's mask (at least
        one byte)."""
        s_float = self.values.dtype.itemsize
        n_intervals = self.block_rowptr.shape[0] - 1
        mask_bytes = self.nblocks * max(1, (self.r * self.c) // 8)
        return (self.nnz * s_float
                + (n_intervals + 1) * s_int
                + self.nblocks * s_int
                + mask_bytes)


def occupancy_model_spc5(nnz: int, nrows: int, avg: float, r: int, c: int,
                         s_float: int = 8, s_int: int = 4) -> float:
    """Paper eq. (2): the closed-form occupancy model of beta(r,c), in
    bytes, from the nonzeros a block ``avg``."""
    return (nnz * s_float
            + nrows * s_int / r
            + nnz * (8 * s_int + r * c) / (8 * max(avg, 1e-12)))


def occupancy_model_csr(nnz: int, nrows: int, s_float: int = 8,
                        s_int: int = 4) -> float:
    """Paper eq. (3): the closed-form occupancy model of CSR, in bytes."""
    return nnz * s_float + nrows * s_int + nnz * s_int


# ----------------------------------------------------------------------------
# Construction / conversion
# ----------------------------------------------------------------------------

def csr_from_dense(dense: np.ndarray) -> CSRMatrix:
    nrows, _ = dense.shape
    rowptr = np.zeros(nrows + 1, dtype=np.int64)
    cols, vals = [], []
    for i in range(nrows):
        nz = np.nonzero(dense[i])[0]
        rowptr[i + 1] = rowptr[i] + nz.shape[0]
        cols.append(nz.astype(np.int32))
        vals.append(dense[i, nz])
    colidx = (np.concatenate(cols) if cols else np.zeros(0, np.int32))
    values = (np.concatenate(vals) if vals else np.zeros(0, dense.dtype))
    return CSRMatrix((nrows, dense.shape[1]), rowptr, colidx, values)


def csr_from_coo(shape: Tuple[int, int], rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray) -> CSRMatrix:
    """Build CSR from COO triplets (duplicates summed)."""
    nrows, ncols = shape
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    # collapse duplicates (the keys are sorted: a neighbour comparison finds
    # them, as np.unique would, without its cost on the chip's host)
    if rows.shape[0]:
        key = rows.astype(np.int64) * ncols + cols.astype(np.int64)
        uniq, inv = _sorted_unique(key, return_inverse=True)
        if uniq.shape[0] == key.shape[0]:
            # no duplicates: the sum into zeros, which turns -0.0 into 0.0
            summed = vals + vals.dtype.type(0)
        else:
            summed = np.zeros(uniq.shape[0], dtype=vals.dtype)
            np.add.at(summed, inv, vals)
        rows = (uniq // ncols).astype(np.int64)
        cols = (uniq % ncols).astype(np.int32)
        vals = summed
    rowptr = np.zeros(nrows + 1, dtype=np.int64)
    np.add.at(rowptr, rows + 1, 1)
    rowptr = np.cumsum(rowptr)
    return CSRMatrix(shape, rowptr, cols.astype(np.int32), vals)


def _interval_keys(csr: CSRMatrix, r: int, c: int):
    """Each nonzero's row, column and (r-row interval, column) as one int64
    key = interval * span + column, and ``span``: a column plus c stays
    below the next interval's first key."""
    rowptr = np.asarray(csr.rowptr, dtype=np.int64)
    rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64),
                     np.diff(rowptr))
    cols = np.asarray(csr.colidx[:rowptr[-1]], dtype=np.int64)
    span = csr.shape[1] + c
    return rows, cols, (rows // r) * span + cols, span


def _sorted_unique(keys: np.ndarray, return_inverse: bool = False):
    """``np.unique`` of int64 keys by an explicit sort (or stable argsort
    when the inverse is wanted) and a neighbour comparison: numpy 2.3's
    ``np.unique`` took about 50 s for 26 M keys where the sort takes about
    one, on the host of an H100 machine (PERF.md)."""
    order = np.argsort(keys, kind="stable") if return_inverse else None
    sk = keys[order] if return_inverse else np.sort(keys)
    first = np.ones(sk.shape[0], dtype=bool)
    np.not_equal(sk[1:], sk[:-1], out=first[1:])
    if not return_inverse:
        return sk[first]
    inv = np.empty(keys.shape[0], dtype=np.int64)
    inv[order] = np.cumsum(first) - 1
    return sk[first], inv


def _greedy_opens(ukeys: np.ndarray, c: int, span: int) -> np.ndarray:
    """Over the sorted unique keys, True where the greedy cover opens a
    block: in each interval a block opens at the leftmost uncovered column
    and spans c columns. The keys are unique and increasing, so the next
    block opens at most c keys later: c - 1 streaming comparisons find it
    (a binary search per key misses the cache on every step at this size).
    Every interval then walks its cover at once, one numpy step per block of
    the longest cover, not one Python step per block of the matrix."""
    n = ukeys.shape[0]
    nxt = np.arange(1, n + 1)
    for k in range(1, min(c, n)):
        nxt[:n - k] += ukeys[k:] < ukeys[:n - k] + c
    pos = np.flatnonzero(np.diff(ukeys // span, prepend=-1))  # first keys
    end = np.append(pos[1:], n)
    opens = np.zeros(n, dtype=bool)
    while pos.shape[0]:
        opens[pos] = True
        pos = nxt[pos]
        inside = pos < end
        pos, end = pos[inside], end[inside]
    return opens


def csr_to_spc5(csr: CSRMatrix, r: int, c: int) -> SPC5Matrix:
    """Convert CSR to beta(r, c).

    Greedy left-to-right block construction per r-row interval, exactly the
    coverage the paper's figures show: a block opens at the leftmost uncovered
    nonzero column of the interval and spans c columns. All intervals are
    converted at once (:func:`_greedy_opens`); the bytes are those of the
    reference's interval-by-interval loop.
    """
    rows, cols, _, _ = _interval_keys(csr, r, c)
    return coo_to_spc5(csr.shape, rows, cols, csr.values[:rows.shape[0]], r,
                       c)


def coo_to_spc5(shape: Tuple[int, int], rows: np.ndarray, cols: np.ndarray,
                vals: np.ndarray, r: int, c: int) -> SPC5Matrix:
    """beta(r, c) of the distinct nonzeros at (rows, cols) (int64, in any
    order) holding ``vals``: what :func:`csr_to_spc5` makes of their CSR,
    without building it (the blocks, their masks and the values' order
    depend only on the positions)."""
    if r * c > 32:
        raise ValueError(f"mask must fit uint32, got r*c={r*c}")
    nrows, ncols = shape
    n_intervals = -(-nrows // r)
    span = ncols + c
    keys = (rows // r) * span + cols
    ukeys, inv = _sorted_unique(keys, return_inverse=True)
    opens = _greedy_opens(ukeys, c, span)
    starts = ukeys[opens]                      # block keys, in block order
    bidx = (np.cumsum(opens) - 1)[inv]         # each nonzero's block
    start_col = starts % span
    lrows = rows % r
    bit = (lrows * c + (cols - start_col[bidx])).astype(np.uint32)
    # values in block order, row-major inside block == sort by
    # (block, local_row, col) == by (block, bit), r*c <= 32
    order = np.argsort(bidx * 32 + bit, kind="stable")
    nblocks = starts.shape[0]
    # every block holds a nonzero, so no segment of the reduction is empty
    counts = np.bincount(bidx, minlength=nblocks)
    masks = (np.bitwise_or.reduceat(np.uint32(1) << bit[order],
                                    np.cumsum(counts) - counts)
             .astype(np.uint32) if nblocks else np.zeros(0, np.uint32))
    rowptr = np.zeros(n_intervals + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(starts // span,
                                       minlength=n_intervals))
    voffset = (exclusive_prefix_popcount(masks) if nblocks
               else np.zeros(0, np.int64))
    return SPC5Matrix((nrows, ncols), r, c, rowptr, start_col.astype(np.int32),
                      masks, voffset.astype(np.int64), vals[order])


def spc5_to_coo(mat: SPC5Matrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode beta(r,c) back to COO triplets (int64 rows and columns, a copy
    of the values), vectorised: values lie in block order, row-major inside
    each block, which is ``np.nonzero``'s order over the (nblocks, r*c) bit
    matrix, so ``mat.values`` maps one to one onto the decoded pairs."""
    r, c = mat.r, mat.c
    if mat.nblocks == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, mat.values.dtype))
    n_intervals = mat.block_rowptr.shape[0] - 1
    interval_of_block = np.repeat(
        np.arange(n_intervals, dtype=np.int64), np.diff(mat.block_rowptr))
    k = np.arange(r * c, dtype=np.uint32)
    bits = ((mat.block_masks[:, None] >> k[None, :]) & np.uint32(1)) != 0
    b_idx, k_idx = np.nonzero(bits)          # block-major, bit-ascending
    rows = interval_of_block[b_idx] * r + k_idx // c
    cols = mat.block_colidx[b_idx].astype(np.int64) + k_idx % c
    return rows, cols, mat.values.copy()


def spc5_to_csr(mat: SPC5Matrix) -> CSRMatrix:
    """The exact inverse of :func:`csr_to_spc5`, through
    :func:`spc5_to_coo`."""
    rows, cols, vals = spc5_to_coo(mat)
    return csr_from_coo(mat.shape, rows, cols, vals)


def as_csr(m) -> CSRMatrix:
    """A CSRMatrix or an SPC5Matrix as CSR (the structure and reorder
    modules take either)."""
    return spc5_to_csr(m) if isinstance(m, SPC5Matrix) else m


def beta_breakeven_avg(r: int, c: int, s_int: int = 4) -> float:
    """Paper eq. (4): minimum Avg(r,c) for beta(r,c) to beat CSR's last term."""
    return 1.0 + (r * c) / (8.0 * s_int)


def block_stats(csr: CSRMatrix, r: int, c: int) -> Tuple[int, float]:
    """(N_blocks(r,c), Avg(r,c)) without materializing the format's values.

    This is the cheap statistic the paper's selector uses *before* conversion:
    the blocks of :func:`csr_to_spc5`'s greedy cover, counted.
    """
    _, _, keys, span = _interval_keys(csr, r, c)
    nblocks = int(np.count_nonzero(_greedy_opens(_sorted_unique(keys), c,
                                                 span)))
    return nblocks, csr.nnz / max(nblocks, 1)


def popcount_u32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    out = np.zeros(x.shape, dtype=np.int32)
    for k in range(32):
        out += ((x >> np.uint32(k)) & np.uint32(1)).astype(np.int32)
    return out


def exclusive_prefix_popcount(masks: np.ndarray, axis: int = -1) -> np.ndarray:
    """Exclusive prefix sum of mask popcounts along ``axis``: the offset
    each block's packed values start at (the paper's voffset)."""
    pop = popcount_u32(np.asarray(masks)).astype(np.int64)
    return np.cumsum(pop, axis=axis) - pop


# ----------------------------------------------------------------------------
# Lowering byte models and the descriptor tables
# ----------------------------------------------------------------------------

def narrow_index_dtype(max_value: int) -> np.dtype:
    """Narrowest signed integer dtype that represents ``[0, max_value]``."""
    if max_value <= np.iinfo(np.int8).max:
        return np.dtype(np.int8)
    if max_value <= np.iinfo(np.int16).max:
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def descriptor_lane_nbytes(vmax: int, xmax: int, ymax: int) -> int:
    """Bytes per descriptor LANE at the narrowed table dtypes: one int8
    ``valid`` byte plus the narrowed itemsizes of ``vidx`` (bounded by
    vmax), ``xcol`` (by xmax) and ``yrow`` (by ymax)."""
    return 1 + sum(narrow_index_dtype(max(b - 1, 0)).itemsize
                   for b in (vmax, xmax, ymax))


#: int32 words per descriptor lane (valid, vidx, xcol, yrow) before
#: narrowing: the storage the ``descriptor`` lowering trades against the
#: mask decode's work.
DESC_WORDS_PER_LANE = 4


def descriptor_table_bytes(nblocks: int, r: int, c: int,
                           s_int: int = 4) -> int:
    """Extra index bytes of the descriptor lowering: 4 int32 per block LANE
    (r*c lanes per block) instead of the mask lowering's 4 int32 per BLOCK.
    """
    return nblocks * r * c * DESC_WORDS_PER_LANE * s_int


def spmv_bytes_per_nnz(r: int, c: int, avg: float, lowering: str = "mask",
                       s_float: int = 4, s_int: int = 4,
                       desc_lane_nbytes: Optional[int] = None) -> float:
    """Device-memory bytes per nonzero of one SpMV pass, per lowering.

    Both lowerings stream the packed values (``s_float`` bytes each) and
    one chunk-base int per block; the mask lowering adds 4 int32 per block
    (mask, voffset, colidx, row), the descriptor lowering
    ``desc_lane_nbytes`` per block lane (default: 4 int32 words)."""
    avg = max(avg, 1e-12)
    if lowering == "descriptor":
        lane = (DESC_WORDS_PER_LANE * s_int if desc_lane_nbytes is None
                else desc_lane_nbytes)
        per_block = lane * r * c
    else:
        per_block = 4 * s_int
    return s_float + (per_block + s_int) / avg


@dataclasses.dataclass
class ChunkDescriptors:
    """The chunk masks expanded at build time into per-lane gather tables.

    One entry per block LANE (bit position): ``valid`` is the mask bit,
    ``vidx`` the lane's value index inside its chunk's value window,
    ``xcol`` the x gather index and ``yrow`` the y scatter index, which are
    what the mask kernels recompute on every call. Shapes follow the source
    arrays with a trailing ``r*c`` axis: ``(nchunks, cb, r*c)`` for the
    whole-vector layout, ``(npanels, nchunks, cb, r*c)`` for panels (where
    ``xcol`` is window-relative and ``yrow`` panel-relative). ``valid`` is
    int8; each index table is narrowed to the smallest signed integer its
    bound allows (:func:`narrow_index_dtype`)."""

    valid: np.ndarray  # int8, mask bit per lane (0 => padding lane)
    vidx: np.ndarray   # int8/int16/int32, value index within chunk window
    xcol: np.ndarray   # int8/int16/int32, x gather (col_map pre-folded)
    yrow: np.ndarray   # int8/int16/int32, y scatter index

    @property
    def lane_nbytes(self) -> int:
        """Actual bytes per lane across the four tables."""
        return (self.valid.dtype.itemsize + self.vidx.dtype.itemsize
                + self.xcol.dtype.itemsize + self.yrow.dtype.itemsize)


#: Lanes :func:`chunk_descriptors` expands per slice (2**24 lanes: about
#: 130 MB per int64 temporary).
DESC_SLICE_LANES = 2 ** 24


def chunk_descriptors(chunk_mask: np.ndarray, chunk_voff: np.ndarray,
                      chunk_col: np.ndarray, chunk_row: np.ndarray, *,
                      r: int, c: int, vmax: int, xmax: int, ymax: int,
                      col_map: Optional[np.ndarray] = None
                      ) -> ChunkDescriptors:
    """Expand chunk masks once into :class:`ChunkDescriptors`.

    Works on any leading shape. ``xmax``/``ymax`` are the gather/scatter
    clip bounds (ncols/nrows for the whole-vector layout, xw/pr for panels);
    ``col_map`` folds a column permutation into ``xcol``. Clipped lanes are
    always ``valid == 0``. The bytes are the reference's, but the work goes
    in slices of about :data:`DESC_SLICE_LANES` lanes along the flattened
    leading axes, each written into the narrowed output: the reference's
    int64 temporaries span all lanes at once (about 1.7 GB each for a
    64,000 x 4,096 layer in beta(4,8)), these span one slice, so the host
    peak stays near the output's own size."""
    rc = r * c
    lead = chunk_mask.shape
    cb = lead[-1]
    masks = np.asarray(chunk_mask).reshape(-1, cb)
    voffs = np.asarray(chunk_voff).reshape(-1, cb)
    cols = np.asarray(chunk_col).reshape(-1, cb)
    rows = np.asarray(chunk_row).reshape(-1, cb)
    cmap = None if col_map is None else np.asarray(col_map, dtype=np.int64)
    out = ChunkDescriptors(
        np.empty((masks.shape[0], cb, rc), np.int8),
        np.empty((masks.shape[0], cb, rc), narrow_index_dtype(vmax - 1)),
        np.empty((masks.shape[0], cb, rc), narrow_index_dtype(xmax - 1)),
        np.empty((masks.shape[0], cb, rc), narrow_index_dtype(ymax - 1)))
    k = np.arange(rc, dtype=np.uint32)
    kk = np.arange(rc, dtype=np.int64)
    step = max(1, DESC_SLICE_LANES // max(1, cb * rc))
    for s in range(0, masks.shape[0], step):
        sl = slice(s, s + step)
        bits = ((masks[sl, :, None].astype(np.uint32) >> k)
                & np.uint32(1)).astype(np.int32)
        ranks = np.cumsum(bits, axis=-1, dtype=np.int64) - bits
        out.valid[sl] = bits
        out.vidx[sl] = np.clip(voffs[sl, :, None].astype(np.int64) + ranks,
                               0, vmax - 1)
        xcol = np.clip(cols[sl, :, None].astype(np.int64) + (kk % c),
                       0, xmax - 1)
        out.xcol[sl] = xcol if cmap is None else cmap[xcol]
        out.yrow[sl] = np.clip(rows[sl, :, None].astype(np.int64)
                               + (kk // c), 0, ymax - 1)
    shape = (*lead, rc)
    return ChunkDescriptors(out.valid.reshape(shape),
                            out.vidx.reshape(shape),
                            out.xcol.reshape(shape),
                            out.yrow.reshape(shape))


# ----------------------------------------------------------------------------
# Chunked device layout (whole-vector kernels)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class SPC5Chunked:
    """Fixed-size chunks of CB blocks each, value windows 8-value aligned.

    Every chunk has the same static shape; the values array stays packed
    except chunk starts are rounded up to ``align`` values. Pad blocks have
    mask == 0 (they load nothing and contribute nothing). Because chunk
    starts and ``vmax`` are multiples of ``align`` (8), every chunk's value
    window ``[vbase, vbase + vmax)`` is 32-byte aligned in f32, and the tail
    is padded so the last window stays in bounds.
    """

    shape: Tuple[int, int]
    r: int
    c: int
    cb: int                 # blocks per chunk
    vmax: int               # max values per chunk window (static tile size)
    nchunks: int
    chunk_col: np.ndarray   # int32 (nchunks, cb)   block left column
    chunk_mask: np.ndarray  # uint32 (nchunks, cb)  0 => padding block
    chunk_voff: np.ndarray  # int32 (nchunks, cb)   value offset within window
    chunk_row: np.ndarray   # int32 (nchunks, cb)   global top row of block
    chunk_vbase: np.ndarray  # int32 (nchunks,)     aligned start into values
    values: np.ndarray      # float (nvals_padded,)
    nnz: int

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]


# ----------------------------------------------------------------------------
# Row-panel-tiled device layout (panel kernels)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class SPC5Panels:
    """Row-panel-tiled chunked layout.

      * rows are cut into panels of ``pr`` rows (``pr`` a multiple of ``r``,
        so the r-row-aligned blocks NEVER straddle a panel boundary: a
        panel's rows are written by that panel's chunks alone);
      * within a panel, blocks are sorted by left column and greedily packed
        into chunks of at most ``cb`` blocks whose columns all fall inside
        one ``xw``-wide window of ``x`` (``chunk_xbase`` is the window start,
        aligned down to ``align``);
      * ``chunk_row`` is panel-relative (in ``[0, pr - r]``) and
        ``chunk_col`` window-relative (in ``[0, xw - c]``);
      * ``values`` stays packed with only chunk-alignment padding.

    Chunk counts are padded to the per-panel maximum so every panel walks
    the same number of chunks; padding chunks have ``mask == 0``. ``x`` must
    be padded to ``ncols_pad`` so every window load stays in bounds.
    """

    shape: Tuple[int, int]
    r: int
    c: int
    pr: int                  # panel height in rows, multiple of r
    cb: int                  # blocks per chunk
    xw: int                  # x-window width per chunk, multiple of align
    vmax: int                # values per chunk window (static tile size)
    npanels: int
    nchunks: int             # chunks per panel (uniform, padded)
    ncols_pad: int           # pad x to this length for in-bounds windows
    chunk_col: np.ndarray    # int32 (npanels, nchunks, cb)  window-relative
    chunk_mask: np.ndarray   # uint32 (npanels, nchunks, cb) 0 => padding
    chunk_voff: np.ndarray   # int32 (npanels, nchunks, cb)  offset in window
    chunk_row: np.ndarray    # int32 (npanels, nchunks, cb)  panel-relative
    chunk_vbase: np.ndarray  # int32 (npanels, nchunks)      into values
    chunk_xbase: np.ndarray  # int32 (npanels, nchunks)      x window start
    values: np.ndarray       # float (nvals_padded,)
    nnz: int

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]


def _panel_chunk_plan(mat: SPC5Matrix, pr: int, cb: int, xw: int,
                      align: int = 8):
    """Pass 1 of :func:`to_panels`: per panel, column-sort blocks and find
    chunk boundaries. Returns ``(panels, pr, xw, npanels)`` where ``panels``
    holds one ``(order, chunk_starts, xbases, nb)`` tuple per panel (None
    for empty panels) and pr/xw are normalised to the layout's alignment
    invariants.
    """
    r, c = mat.r, mat.c
    nrows = mat.shape[0]
    pr = max(r, -(-pr // r) * r)                 # multiple of r
    # a window must hold one block wherever it lands after aligning down
    xw = max(xw, c + align)
    xw = -(-xw // align) * align
    npanels = max(1, -(-nrows // pr))
    intervals_per_panel = pr // r
    n_intervals = mat.block_rowptr.shape[0] - 1
    interval_of_block = np.repeat(
        np.arange(n_intervals, dtype=np.int64), np.diff(mat.block_rowptr))

    panels = []          # (order, chunk_starts, xbases, nb) per panel
    for p in range(npanels):
        it0 = min(p * intervals_per_panel, n_intervals)
        it1 = min((p + 1) * intervals_per_panel, n_intervals)
        b0, b1 = int(mat.block_rowptr[it0]), int(mat.block_rowptr[it1])
        nb = b1 - b0
        if nb == 0:
            panels.append(None)
            continue
        cols = mat.block_colidx[b0:b1].astype(np.int64)
        ivl = interval_of_block[b0:b1]
        order = np.lexsort((ivl, cols)) + b0     # by column, then interval
        scols = mat.block_colidx[order].astype(np.int64)
        starts, xbases = [], []
        s = 0
        while s < nb:
            xbase = (int(scols[s]) // align) * align
            e = min(s + cb, int(np.searchsorted(scols, xbase + xw - c,
                                                side="right")))
            starts.append(s)
            xbases.append(xbase)
            s = e
        panels.append((order, np.asarray(starts, dtype=np.int64),
                       np.asarray(xbases, dtype=np.int64), nb))
    return panels, pr, xw, npanels


def count_panel_chunks(mat: SPC5Matrix, pr: int = 512, cb: int = 64,
                       xw: int = 512, align: int = 8) -> np.ndarray:
    """Chunks of each panel of the (pr, cb, xw) panel layout, int64
    (npanels,): pass 1 of :func:`to_panels` only, so the reorder strategies
    can score a permutation by it (each chunk is one value window and one x
    window to stage)."""
    panels, _, _, npanels = _panel_chunk_plan(mat, pr, cb, xw, align)
    return np.asarray([0 if pp is None else len(pp[1]) for pp in panels],
                      dtype=np.int64)


def to_panels(mat: SPC5Matrix, pr: int = 512, cb: int = 64, xw: int = 512,
              align: int = 8) -> SPC5Panels:
    """Convert beta(r,c) to the row-panel-tiled layout (see SPC5Panels).

    The only per-element Python loop is over CHUNKS (boundary discovery via
    searchsorted); block/value assembly is vectorized.
    """
    r, c = mat.r, mat.c
    nrows, ncols = mat.shape
    panels, pr, xw, npanels = _panel_chunk_plan(mat, pr, cb, xw, align)
    intervals_per_panel = pr // r
    n_intervals = mat.block_rowptr.shape[0] - 1
    pop = popcount_u32(mat.block_masks).astype(np.int64)
    interval_of_block = np.repeat(
        np.arange(n_intervals, dtype=np.int64), np.diff(mat.block_rowptr))

    nchunks = max(1, max((len(pp[1]) for pp in panels if pp is not None),
                         default=1))
    chunk_col = np.zeros((npanels, nchunks, cb), dtype=np.int32)
    chunk_mask = np.zeros((npanels, nchunks, cb), dtype=np.uint32)
    chunk_voff = np.zeros((npanels, nchunks, cb), dtype=np.int32)
    chunk_row = np.zeros((npanels, nchunks, cb), dtype=np.int32)
    chunk_vbase = np.zeros((npanels, nchunks), dtype=np.int32)
    chunk_xbase = np.zeros((npanels, nchunks), dtype=np.int32)

    # -- pass 2: vectorized per-panel assembly
    per_panel = []       # deferred value scatters
    vmax = 0
    ncols_pad = xw
    for p, pp in enumerate(panels):
        if pp is None:
            continue
        order, starts, xbases, nb = pp
        nch_p = starts.shape[0]
        sizes = np.diff(np.append(starts, nb))
        chunk_of = np.repeat(np.arange(nch_p, dtype=np.int64), sizes)
        slot = np.arange(nb, dtype=np.int64) - np.repeat(starts, sizes)
        lens = pop[order]
        cum_excl = np.concatenate([[0], np.cumsum(lens)[:-1]])
        chunk_nnz = np.add.reduceat(lens, starts) if nb else np.zeros(0, np.int64)

        chunk_mask[p, chunk_of, slot] = mat.block_masks[order]
        chunk_col[p, chunk_of, slot] = (
            mat.block_colidx[order].astype(np.int64)
            - np.repeat(xbases, sizes)).astype(np.int32)
        chunk_row[p, chunk_of, slot] = (
            (interval_of_block[order] - p * intervals_per_panel) * r
        ).astype(np.int32)
        chunk_voff[p, chunk_of, slot] = (
            cum_excl - np.repeat(cum_excl[starts], sizes)).astype(np.int32)
        chunk_xbase[p, :nch_p] = xbases
        ncols_pad = max(ncols_pad, int(xbases.max()) + xw)
        vmax = max(vmax, int(chunk_nnz.max()) if nch_p else 0)
        # packed panel values in chunk order (no inter-chunk padding yet)
        total = int(lens.sum())
        src = (np.repeat(mat.block_voffset[order] - cum_excl, lens)
               + np.arange(total, dtype=np.int64))
        per_panel.append((p, nch_p, chunk_nnz, cum_excl[starts], src))

    vmax = max(align, vmax + (-vmax) % align)
    # chunk value windows: aligned exclusive cumsum across (panel, chunk)
    all_nnz = np.concatenate([pp[2] for pp in per_panel]) if per_panel else \
        np.zeros(0, np.int64)
    aligned = -(-all_nnz // align) * align
    vbases = np.concatenate([[0], np.cumsum(aligned)[:-1]]) if aligned.shape[0] \
        else np.zeros(0, np.int64)
    # every chunk's [vbase, vbase + vmax) window must be in bounds, and the
    # last chunk has the largest vbase
    nvals = (int(vbases[-1]) + vmax) if aligned.shape[0] else vmax
    values = np.zeros(nvals, mat.values.dtype)
    ci0 = 0
    for p, nch_p, chunk_nnz, cum_chunk, src in per_panel:
        vb = vbases[ci0:ci0 + nch_p]
        chunk_vbase[p, :nch_p] = vb.astype(np.int32)
        dst = (np.repeat(vb - cum_chunk, chunk_nnz)
               + np.arange(int(chunk_nnz.sum()), dtype=np.int64))
        values[dst] = mat.values[src]
        ci0 += nch_p
    return SPC5Panels(mat.shape, r, c, pr, cb, int(xw), int(vmax), npanels,
                      nchunks, int(ncols_pad), chunk_col, chunk_mask,
                      chunk_voff, chunk_row, chunk_vbase, chunk_xbase, values,
                      mat.nnz)


def to_chunked(mat: SPC5Matrix, cb: int = 256, align: int = 8) -> SPC5Chunked:
    r, c = mat.r, mat.c
    nblocks = mat.nblocks
    nchunks = max(1, -(-nblocks // cb))
    n_intervals = mat.block_rowptr.shape[0] - 1
    interval_of_block = np.repeat(
        np.arange(n_intervals, dtype=np.int64), np.diff(mat.block_rowptr))
    pop = popcount_u32(mat.block_masks).astype(np.int64)

    chunk_col = np.zeros((nchunks, cb), dtype=np.int32)
    chunk_mask = np.zeros((nchunks, cb), dtype=np.uint32)
    chunk_voff = np.zeros((nchunks, cb), dtype=np.int32)
    chunk_row = np.zeros((nchunks, cb), dtype=np.int32)
    chunk_vbase = np.zeros((nchunks,), dtype=np.int32)

    vals_out = []
    vcursor = 0
    vmax = 0
    for ch in range(nchunks):
        b0, b1 = ch * cb, min((ch + 1) * cb, nblocks)
        n = b1 - b0
        if n <= 0:
            chunk_vbase[ch] = vcursor
            continue
        lens = pop[b0:b1]
        local_off = np.concatenate([[0], np.cumsum(lens)[:-1]])
        total = int(lens.sum())
        chunk_col[ch, :n] = mat.block_colidx[b0:b1]
        chunk_mask[ch, :n] = mat.block_masks[b0:b1]
        chunk_voff[ch, :n] = local_off
        chunk_row[ch, :n] = (interval_of_block[b0:b1] * r).astype(np.int32)
        chunk_vbase[ch] = vcursor
        v0 = int(mat.block_voffset[b0])
        vals_out.append(mat.values[v0:v0 + total])
        vmax = max(vmax, total)
        vcursor += total
        pad = (-vcursor) % align
        if pad:
            vals_out.append(np.zeros(pad, mat.values.dtype))
            vcursor += pad
    # round the static window up to alignment, at least one vector
    vmax = max(align, vmax + (-vmax) % align)
    values = (np.concatenate(vals_out) if vals_out
              else np.zeros(0, mat.values.dtype))
    # tail padding so the last window load stays in bounds
    tail_need = (int(chunk_vbase[-1]) + vmax) - values.shape[0]
    if tail_need > 0:
        values = np.concatenate([values, np.zeros(tail_need, mat.values.dtype)])
    return SPC5Chunked(mat.shape, r, c, cb, int(vmax), nchunks, chunk_col,
                       chunk_mask, chunk_voff, chunk_row, chunk_vbase, values,
                       mat.nnz)


# ----------------------------------------------------------------------------
# beta_test variant: singleton blocks split off into a COO tail
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class SPC5TestSplit:
    """The storage side of the paper's beta(r,c)_test kernels: blocks whose
    mask has one set bit become a COO tail (rows, cols, values); the blocks
    with two or more nonzeros stay in beta(r,c)."""

    multi: SPC5Matrix
    single_rows: np.ndarray   # int32 (n_single,)
    single_cols: np.ndarray   # int32 (n_single,)
    single_values: np.ndarray  # float (n_single,)

    @property
    def nnz(self) -> int:
        return self.multi.nnz + int(self.single_values.shape[0])


def split_singletons(mat: SPC5Matrix) -> SPC5TestSplit:
    """Split ``mat`` into its multi-nonzero blocks and a singleton tail,
    byte-equal to the reference's ``split_singletons``. The kept blocks'
    values are gathered with one ``np.repeat`` of their starts plus a
    running offset, where the reference takes one ``np.arange`` per block
    (about 7.9 M Python steps on a 64,000 x 4,096 weight in beta(2,4))."""
    pop = popcount_u32(mat.block_masks)
    is_single = pop == 1
    r, c = mat.r, mat.c
    n_intervals = mat.block_rowptr.shape[0] - 1
    interval_of_block = np.repeat(
        np.arange(n_intervals, dtype=np.int64), np.diff(mat.block_rowptr))

    sblocks = np.nonzero(is_single)[0]
    if sblocks.shape[0]:
        smask = mat.block_masks[sblocks].astype(np.uint32)
        bitpos = np.zeros(sblocks.shape[0], dtype=np.int64)
        for k in range(r * c):
            bitpos[smask == np.uint32(1) << np.uint32(k)] = k
        srow = interval_of_block[sblocks] * r + bitpos // c
        scol = mat.block_colidx[sblocks].astype(np.int64) + bitpos % c
        svals = mat.values[mat.block_voffset[sblocks]]
    else:
        srow = np.zeros(0, np.int64)
        scol = np.zeros(0, np.int64)
        svals = np.zeros(0, mat.values.dtype)

    keep = np.nonzero(~is_single)[0]
    rowptr = np.cumsum(np.bincount(interval_of_block[keep] + 1,
                                   minlength=n_intervals + 1)
                       .astype(np.int64))
    if keep.shape[0]:
        lens = pop[keep].astype(np.int64)
        kvoff = np.concatenate([[0], np.cumsum(lens)[:-1]])
        starts = mat.block_voffset[keep].astype(np.int64)
        vidx = (np.repeat(starts - kvoff, lens)
                + np.arange(int(lens.sum()), dtype=np.int64))
        kvals = mat.values[vidx]
    else:
        kvals = np.zeros(0, mat.values.dtype)
        kvoff = np.zeros(0, np.int64)
    multi = SPC5Matrix(mat.shape, r, c, rowptr,
                       mat.block_colidx[keep], mat.block_masks[keep],
                       kvoff.astype(np.int64), kvals)
    return SPC5TestSplit(multi, srow.astype(np.int32), scol.astype(np.int32),
                         svals)
