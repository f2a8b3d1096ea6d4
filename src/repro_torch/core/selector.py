"""Record-based kernel selection and configuration tuning (paper
§Performance prediction).

The port's copy of ``repro.core.selector``. The best beta(r,c) depends on
the matrix. Following the paper:

  * sequential: per-kernel polynomial interpolation of throughput vs
    Avg NNZ/block (paper fig. 5), argmax over kernels;
  * parallel: non-linear 2-D regression over (threads/devices, Avg NNZ/block)
    (paper fig. 6);
  * records come from previous executions and persist in a JSON store, so the
    selector can be used "before converting a matrix into the format" --
    ``block_stats`` is computable straight from CSR.

Kernels are keyed "r x c" plus the "_test" suffix for the singleton-split
variant, mirroring the paper's beta(r,c)_test naming.

Beyond kernel choice, records carry the full layout configuration
``(layout, pr, xw, cb, reorder, lowering, vdtype)`` plus cheap matrix
features (nnz/row, bandwidth, block fill), so the same record-and-predict
machinery also tunes the plan: :func:`tune` interpolates each recorded
configuration's throughput over the feature space and returns the argmax
:class:`PanelConfig`. ``repro_torch.kernels.ops.prepare`` consults it
whenever a record store is present and no explicit configuration was
requested.

The one addition to the reference is :attr:`Record.backend` (schema v5):
the device a measurement ran on, ``"cuda:<card name>"`` for the card
(:func:`backend_of`) and ``"cpu"`` for the host. Records of older files
load with ``backend=""``. :func:`tune`, :func:`select_kernel` and the
predictors take ``backend``: None applies no filter (the reference's
arithmetic exactly), a name keeps that backend's records only. The plan's
tune pass passes its device's backend, so a record of another device --
every record of the reference's stores, measured in CPU interpret mode on
the TPU's code -- never tunes a port plan.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .formats import (SUPPORTED_BLOCKS, CSRMatrix, SPC5Matrix, block_stats,
                      canonical_vdtype)

DEFAULT_KERNELS: Tuple[str, ...] = tuple(
    f"{r}x{c}" for (r, c) in SUPPORTED_BLOCKS if (r, c) != (1, 4)
) + ("1x8_test", "2x4_test")

#: JSONL record-store schema version (bumped on incompatible field changes).
#: v2 adds the reorder fields (``reorder``/``bandwidth_post``/``nchunks``);
#: v3 adds the kernel-lowering field (``lowering``: "mask" | "descriptor");
#: v4 adds the value-dtype field (``vdtype``: "f32" | "bf16" | "int8");
#: v5 (the port's) adds the backend field (``backend``: "cuda:<card name>"
#: | "cpu"); v1-v4 stores load with the missing fields defaulted ("" ==
#: legacy record, treated as the mask lowering / f32 values -- the only
#: variants that existed -- and as a measurement of no backend of the
#: port's).
RECORDS_VERSION = 5

#: Env var naming a record store (JSON/JSONL file or a directory of stores)
#: that ``ops.prepare`` consults for auto-tuning when the caller passes none.
RECORDS_ENV = "SPC5_RECORDS"


def kernel_block(kernel: str) -> Tuple[int, int]:
    rc = kernel.split("_")[0]
    r, c = rc.split("x")
    return int(r), int(c)


def _canon_layout(name: str) -> str:
    """Normalise a layout name to the plan registry's key set.

    The registry (``repro_torch.core.plan``) is the one source of truth for layout
    names; this shim maps legacy spellings in old JSONL stores ("whole" ->
    "whole_vector") and leaves the sentinels "auto" (let the layout pass
    pick) and "" (legacy record, layout inferred from ``pr``) untouched.
    Imported lazily so the selector stays a leaf module.
    """
    if name in ("", "auto"):
        return name
    from . import plan
    return plan.canonical_layout(name)


#: The plan registry's lowering names, which pass :func:`_canon_lowering`
#: without importing the registry (``repro_torch.core.plan`` imports this
#: module, and :data:`DEFAULT_CONFIG` is built at import).
_LOWERINGS = ("mask", "descriptor")


def _canon_lowering(name: str, legacy_as_mask: bool = False) -> str:
    """Validate a lowering name against the plan registry's variant names.

    ``""`` marks a legacy (pre-v3) record; ``legacy_as_mask`` maps it to
    "mask" (what those measurements actually ran), which is how a config's
    identity is normalised so v1/v2 records pool with v3 mask records.
    """
    if name == "":
        return "mask" if legacy_as_mask else name
    if name in _LOWERINGS:
        return name
    from . import plan
    return plan.canonical_lowering(name)


@dataclasses.dataclass(frozen=True)
class PanelConfig:
    """A device-layout configuration for ``ops.prepare``.

    ``layout`` is a plan-registry key ("whole_vector", "panels", "test") or
    "auto" (let ``prepare`` pick by VMEM fit); legacy spellings ("whole")
    are normalised at construction so the registry's key set stays the one
    source of truth. ``pr``/``xw`` only matter for the panel-tiled layout;
    ``cb=None`` means the layout's default chunk size. ``reorder`` names the
    ``repro_torch.core.reorder`` strategy the measurement ran under ("" = no
    reordering); it is part of the configuration identity, so the tuner
    learns when reordering pays and ``ops.prepare`` applies the winning
    strategy along with the tuned geometry. ``lowering`` names the kernel
    variant ("mask" = the bit-mask decode, "descriptor" = build-time gather
    tables); it completes the configuration identity so the tuner learns
    per-matrix which side of the bytes-vs-decode trade wins (legacy ""
    normalises to "mask", the only variant that existed pre-v3).
    ``vdtype`` names the value store the measurement ran at ("f32" |
    "bf16" | "int8", schema v4); legacy "" normalises to "f32" -- the only
    store that existed pre-v4 -- so old records pool with v4 f32 records
    and the tuner learns per-matrix when quantisation pays.
    """

    layout: str = "auto"
    pr: int = 512
    xw: int = 512
    cb: Optional[int] = None
    reorder: str = ""
    lowering: str = "mask"
    vdtype: str = "f32"

    def __post_init__(self):
        object.__setattr__(self, "layout", _canon_layout(self.layout))
        object.__setattr__(self, "lowering",
                           _canon_lowering(self.lowering, legacy_as_mask=True))
        object.__setattr__(self, "vdtype",
                           canonical_vdtype(self.vdtype) or "f32")


#: What ``tune`` returns when no record is usable -- matches the fixed
#: defaults ``ops.prepare`` used before auto-tuning existed.
DEFAULT_CONFIG = PanelConfig()


@dataclasses.dataclass(frozen=True)
class MatrixFeatures:
    """Cheap per-matrix statistics the tuner interpolates over.

    All computable from CSR (or the converted beta(r,c)) without touching
    values: the paper's "before converting a matrix into the format"
    property is preserved.
    """

    nrows: int
    ncols: int
    nnz: int
    nnz_row: float     # NNZ / nrows
    bandwidth: float   # mean |col - row| over nonzeros (block-centre approx)
    avg: float         # Avg NNZ/block for the (r,c) under consideration
    fill: float        # avg / (r*c), in [0, 1]

    def vector(self, workers: int = 1) -> np.ndarray:
        """Interpolation coordinates; log-compress the heavy-tailed dims."""
        return np.array([
            self.avg,
            np.log1p(self.nnz_row),
            np.log1p(self.bandwidth),
            np.log2(max(workers, 1)),
        ], dtype=np.float64)


def csr_features(csr: CSRMatrix, r: int, c: int) -> MatrixFeatures:
    """Features straight from CSR (pre-conversion, paper-style)."""
    _, avg = block_stats(csr, r, c)
    nnz = csr.nnz
    if nnz:
        rows = np.repeat(np.arange(csr.nrows, dtype=np.int64),
                         np.diff(csr.rowptr).astype(np.int64))
        bw = float(np.abs(csr.colidx.astype(np.int64) - rows).mean())
    else:
        bw = 0.0
    return MatrixFeatures(csr.nrows, csr.ncols, nnz, nnz / max(csr.nrows, 1),
                          bw, avg, avg / (r * c))


def spc5_features(mat: SPC5Matrix) -> MatrixFeatures:
    """Features from an already-converted beta(r,c) matrix (block-level
    bandwidth approximation: |block left col - block top row|)."""
    n_intervals = mat.block_rowptr.shape[0] - 1
    if mat.nblocks:
        interval_of_block = np.repeat(
            np.arange(n_intervals, dtype=np.int64),
            np.diff(mat.block_rowptr).astype(np.int64))
        bw = float(np.abs(mat.block_colidx.astype(np.int64)
                          - interval_of_block * mat.r).mean())
    else:
        bw = 0.0
    return MatrixFeatures(mat.nrows, mat.ncols, mat.nnz,
                          mat.nnz / max(mat.nrows, 1), bw,
                          mat.avg_nnz_per_block, mat.fill_ratio)


@dataclasses.dataclass
class Record:
    kernel: str
    avg: float        # Avg NNZ/block for this kernel's (r,c) on the matrix
    workers: int      # 1 == sequential
    gflops: float
    matrix: str = ""
    pr: int = 0       # row-panel height of the tiled layout; 0 == whole-vector
    xw: int = 0       # panel x-window width; 0 == n/a (whole-vector/legacy)
    cb: int = 0       # chunk size; 0 == layout default / legacy record
    layout: str = ""  # plan-registry key; "" == legacy (inferred from pr)
    nnz_row: float = 0.0    # matrix features at measurement time (0 == legacy)
    bandwidth: float = 0.0
    fill: float = 0.0
    # Reordering (repro_torch.core.reorder): the strategy this measurement ran
    # under ("" = none) and the features AFTER the permutation. The feature
    # coordinates above stay PRE-reorder -- at tune time the caller only has
    # the unreordered matrix -- so the post fields are evidence of what the
    # strategy achieved, not interpolation inputs.
    reorder: str = ""
    bandwidth_post: float = 0.0
    nchunks: int = 0  # total panel chunks of the measured layout (DMA proxy)
    # Kernel lowering the measurement ran under (schema v3): "mask" |
    # "descriptor"; "" == legacy v1/v2 record (ran the mask decode, the
    # only variant that existed -- config() normalises it so legacy records
    # pool with v3 mask measurements).
    lowering: str = ""
    # Value dtype the measurement ran at (schema v4): "f32" | "bf16" |
    # "int8"; "" == legacy v1-v3 record (ran f32 values, the only store
    # that existed -- config() normalises it so legacy records pool with
    # v4 f32 measurements).
    vdtype: str = ""
    # Device the measurement ran on (schema v5, the port's addition):
    # "cuda:<card name>" (backend_of) | "cpu"; "" == a record of an older
    # file (the reference's), which no port plan is tuned from.
    backend: str = ""

    def __post_init__(self):
        # loader shim: legacy layout spellings in old stores normalise to
        # the plan registry's key set ("" stays "", inferred in config())
        self.layout = _canon_layout(self.layout)
        self.lowering = _canon_lowering(self.lowering)
        self.vdtype = canonical_vdtype(self.vdtype)

    def config(self) -> PanelConfig:
        """Normalised layout configuration this record measured."""
        layout = self.layout or ("panels" if self.pr else "whole_vector")
        return PanelConfig(layout=layout, pr=int(self.pr), xw=int(self.xw),
                           cb=int(self.cb) if self.cb else None,
                           reorder=self.reorder, lowering=self.lowering,
                           vdtype=self.vdtype)

    def features(self) -> MatrixFeatures:
        rc = kernel_block(self.kernel)
        return MatrixFeatures(0, 0, 0, self.nnz_row, self.bandwidth,
                              self.avg, self.fill or self.avg / (rc[0] * rc[1]))


class RecordStore:
    """Persistent store of (kernel, config, features) -> throughput records.

    ``pr`` records which device layout produced the measurement: 0 is the
    VMEM-resident whole-vector path, otherwise the row-panel height of the
    panel-tiled kernels. ``xw``/``cb``/``layout`` complete the configuration
    and ``nnz_row``/``bandwidth``/``fill`` snapshot the matrix features, so
    :func:`tune` can interpolate per-config throughput. Old JSON stores
    without the newer fields load with the dataclass defaults (legacy
    records still feed the kernel selector; the tuner treats them as the
    default-config measurement of their layout).

    Two on-disk formats: the original single-JSON-array ``save``/load, and a
    versioned JSONL store (``save_jsonl``/:func:`load_records`) whose files
    can be merged across runs -- the CI artifact format.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[Record] = []
        #: malformed entries skipped while loading (store metadata; the
        #: verifier's ``store-load`` rule flags a nonzero count)
        self.skipped: int = 0
        if path and os.path.exists(path):
            self.records, self.skipped = _load_any(path)

    def add(self, kernel: str, avg: float, workers: int, gflops: float,
            matrix: str = "", pr: int = 0, xw: int = 0, cb: int = 0,
            layout: str = "", nnz_row: float = 0.0, bandwidth: float = 0.0,
            fill: float = 0.0, reorder: str = "",
            bandwidth_post: float = 0.0, nchunks: int = 0,
            lowering: str = "", vdtype: str = "",
            backend: str = "") -> None:
        self.records.append(Record(kernel, float(avg), int(workers),
                                   float(gflops), matrix, int(pr), int(xw),
                                   int(cb), layout, float(nnz_row),
                                   float(bandwidth), float(fill), reorder,
                                   float(bandwidth_post), int(nchunks),
                                   lowering, vdtype, backend))

    def add_measurement(self, kernel: str, feats: MatrixFeatures,
                        config: PanelConfig, workers: int, gflops: float,
                        matrix: str = "", bandwidth_post: float = 0.0,
                        nchunks: int = 0, backend: str = "") -> None:
        """Full-schema add: config + features in one call (sweep mode).

        ``feats`` are the matrix's PRE-reorder features (the tune-time
        coordinates); ``config.reorder`` names the strategy the measurement
        ran under, ``config.lowering`` the kernel variant, and
        ``bandwidth_post``/``nchunks`` record what the reordering achieved
        (see :class:`Record`); ``backend`` the device it ran on
        (:func:`backend_of`).
        """
        self.add(kernel, feats.avg, workers, gflops, matrix=matrix,
                 pr=config.pr if config.layout == "panels" else 0,
                 xw=config.xw if config.layout == "panels" else 0,
                 cb=config.cb or 0, layout=config.layout,
                 nnz_row=feats.nnz_row, bandwidth=feats.bandwidth,
                 fill=feats.fill, reorder=config.reorder,
                 bandwidth_post=bandwidth_post, nchunks=nchunks,
                 lowering=config.lowering, vdtype=config.vdtype,
                 backend=backend)

    def extend(self, other: "RecordStore") -> "RecordStore":
        self.records.extend(other.records)
        return self

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if not path:
            raise ValueError("no path for RecordStore.save")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump([dataclasses.asdict(r) for r in self.records], f)
        os.replace(tmp, path)

    def save_jsonl(self, path: Optional[str] = None) -> None:
        """Versioned JSONL: a header line then one record per line.

        Append-friendly and mergeable: :func:`load_records` accepts a
        directory of these files and concatenates them (deduplicating exact
        duplicates), so every CI run can drop its own file into the store.
        """
        path = path or self.path
        if not path:
            raise ValueError("no path for RecordStore.save_jsonl")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({"spc5_records_version": RECORDS_VERSION}) + "\n")
            for r in self.records:
                f.write(json.dumps(dataclasses.asdict(r)) + "\n")
        os.replace(tmp, path)

    def kernels(self) -> List[str]:
        return sorted({r.kernel for r in self.records})

    def configs(self, kernel: Optional[str] = None,
                layout: Optional[str] = None) -> List[PanelConfig]:
        """Distinct measured configurations (optionally for one kernel)."""
        seen = []
        for r in self.records:
            if kernel is not None and r.kernel != kernel:
                continue
            cfg = r.config()
            if layout is not None and cfg.layout != layout:
                continue
            if cfg not in seen:
                seen.append(cfg)
        return seen


def _record_from(obj, path: str, where: str) -> Optional[Record]:
    """One record from a decoded JSON object, or None when malformed (the
    caller counts the skip). CI artifact stores accumulate across runs;
    one truncated or hand-edited line must not poison the whole merge."""
    try:
        if not isinstance(obj, dict):
            raise TypeError(f"expected an object, got {type(obj).__name__}")
        return Record(**obj)
    except (TypeError, ValueError) as e:
        warnings.warn(f"{path}: skipping malformed record {where}: {e}",
                      stacklevel=2)
        return None


def _load_jsonl(path: str) -> Tuple[List[Record], int]:
    """(records, skipped-line count) of one JSONL store file."""
    records: List[Record] = []
    skipped = 0
    with open(path) as f:
        first = f.readline()
        if not first.strip():
            return records, skipped
        try:
            head = json.loads(first)
        except json.JSONDecodeError as e:
            warnings.warn(f"{path}: skipping malformed line 1: {e}",
                          stacklevel=2)
            head, skipped = None, skipped + 1
        if isinstance(head, dict) and "spc5_records_version" in head:
            ver = head["spc5_records_version"]
            if ver > RECORDS_VERSION:
                raise ValueError(
                    f"{path}: records version {ver} is newer than supported "
                    f"{RECORDS_VERSION}")
        elif head is not None:      # headerless JSONL: first line is a record
            rec = _record_from(head, path, "line 1")
            if rec is None:
                skipped += 1
            else:
                records.append(rec)
        for lineno, line in enumerate(f, start=2):
            if not line.strip():
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                warnings.warn(f"{path}: skipping malformed line {lineno}: "
                              f"{e}", stacklevel=2)
                skipped += 1
                continue
            rec = _record_from(obj, path, f"line {lineno}")
            if rec is None:
                skipped += 1
            else:
                records.append(rec)
    return records, skipped


def _load_any(path: str) -> Tuple[List[Record], int]:
    """Load one store file: legacy JSON array, versioned JSONL, or a
    ``BENCH_spmv.json`` payload (whose ``records`` list uses the same
    schema) -- so pointing at a downloaded CI artifact directory Just Works.
    Returns ``(records, skipped)``; malformed entries are skipped with a
    warning, not fatal (see :func:`load_records`).
    """
    try:                                    # whole-file JSON first: array or
        with open(path) as f:               # a BENCH payload (indented dict)
            payload = json.load(f)
    except json.JSONDecodeError:
        return _load_jsonl(path)            # line-delimited store

    def from_list(objs):
        recs = [_record_from(o, path, f"entry {i}")
                for i, o in enumerate(objs)]
        kept = [r for r in recs if r is not None]
        return kept, len(recs) - len(kept)

    if isinstance(payload, list):
        return from_list(payload)
    if isinstance(payload, dict):
        if isinstance(payload.get("records"), list):
            ver = payload.get("version", RECORDS_VERSION)
            if ver > RECORDS_VERSION:
                raise ValueError(f"{path}: records version {ver} is newer "
                                 f"than supported {RECORDS_VERSION}")
            return from_list(payload["records"])
        if "spc5_records_version" in payload:
            return [], 0                    # header-only (empty) JSONL store
        if "kernel" in payload:
            return from_list([payload])     # single-line headerless JSONL
    raise ValueError(f"{path}: not a recognisable record store")


def load_records(path: str) -> RecordStore:
    """Load + merge a record store: a file, or a directory of store files.

    Directories merge every ``*.jsonl``/``*.json`` inside (sorted, so the
    merge is deterministic); exact duplicate records (e.g. the same CI
    artifact downloaded twice) are dropped. Malformed lines/entries are
    skipped with a warning each and counted in the returned store's
    ``skipped`` metadata (``repro_torch.analysis.verify.verify_records`` surfaces
    a nonzero count) -- one bad line in an accumulated CI artifact must not
    abort the whole merge.
    """
    store = RecordStore()
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.jsonl"))
                       + glob.glob(os.path.join(path, "*.json")))
    else:
        files = [path]
    seen = set()
    for fp in files:
        recs, skipped = _load_any(fp)
        store.skipped += skipped
        for r in recs:
            key = tuple(dataclasses.asdict(r).items())
            if key not in seen:
                seen.add(key)
                store.records.append(r)
    return store


def backend_of(device) -> str:
    """The backend name of ``device`` that the port's records carry:
    ``"cuda:<torch.cuda.get_device_name>"`` for a card, ``"cpu"`` for the
    host."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def _of_backend(r: Record, backend: Optional[str]) -> bool:
    """A record's backend filter: None keeps every record."""
    return backend is None or r.backend == backend


def has_backend(store: Optional[RecordStore], backend: Optional[str]) -> bool:
    """True where ``store`` holds a record of ``backend`` (of any backend
    for None)."""
    return store is not None and any(_of_backend(r, backend)
                                     for r in store.records)


# -- Default store (env-configured), consulted by ``ops.prepare`` -----------

_default_store: Optional[RecordStore] = None
_default_store_src: Optional[str] = None


def set_default_store(store: Optional[RecordStore]) -> None:
    """Install a process-wide store for auto-tuning (None clears it)."""
    global _default_store, _default_store_src
    _default_store = store
    _default_store_src = "<explicit>" if store is not None else None


def get_default_store() -> Optional[RecordStore]:
    """The store ``ops.prepare`` tunes against when the caller passes none.

    Resolution order: a store installed via :func:`set_default_store`, else
    the path in ``$SPC5_RECORDS`` (file or directory; loaded once and cached
    until the env var changes). Returns None when neither is present.
    """
    global _default_store, _default_store_src
    if _default_store_src == "<explicit>":
        return _default_store
    src = os.environ.get(RECORDS_ENV)
    if not src:
        _default_store, _default_store_src = None, None
        return None
    if src != _default_store_src:
        try:
            _default_store = load_records(src)
        except (OSError, ValueError, TypeError) as e:
            warnings.warn(
                f"{RECORDS_ENV}={src!r} could not be loaded ({e!r}); "
                f"auto-tuning is DISABLED until the env var changes",
                RuntimeWarning, stacklevel=2)
            _default_store = None
        _default_store_src = src
    return _default_store


class SequentialPredictor:
    """Per-kernel polyfit of gflops vs Avg NNZ/block (paper fig. 5).

    Queries outside a kernel's fitted Avg range clamp to the nearest fitted
    point: the polynomial is an interpolation model and extrapolating a
    degree-2 fit is unbounded (a kernel measured only at low fill would get
    an arbitrarily inflated/deflated score on a dense matrix).
    """

    def __init__(self, store: RecordStore, degree: int = 2, pr: int = 0,
                 backend: Optional[str] = None):
        self.coeffs: Dict[str, np.ndarray] = {}
        self.clip: Dict[str, Tuple[float, float]] = {}
        for k in store.kernels():
            # fit one layout at a time: mixing whole-vector (pr=0) and
            # panel-tiled records would fit a curve through two different
            # kernels' throughputs at the same Avg
            pts = [(r.avg, r.gflops) for r in store.records
                   if r.kernel == k and r.workers == 1 and r.pr == pr
                   and _of_backend(r, backend)]
            if not pts:
                continue
            xs = np.array([p[0] for p in pts])
            ys = np.array([p[1] for p in pts])
            deg = min(degree, max(0, len(pts) - 1))
            self.coeffs[k] = np.polyfit(xs, ys, deg)
            self.clip[k] = (float(xs.min()), float(xs.max()))

    def predict(self, kernel: str, avg: float) -> float:
        if kernel not in self.coeffs:
            return -np.inf
        lo, hi = self.clip[kernel]
        return float(np.polyval(self.coeffs[kernel], min(max(avg, lo), hi)))


class ParallelPredictor:
    """2-D non-linear least squares over (avg, workers) (paper fig. 6).

    Basis: [1, a, w, a*w, a^2, w^2] with a=avg, w=log2(workers) -- "simple
    interpolation of results from previous executions", per the paper.
    Queries clamp ``avg`` to each kernel's fitted range, same as the
    sequential predictor: the quadratic basis extrapolates unboundedly.
    """

    @staticmethod
    def _basis(avg: np.ndarray, workers: np.ndarray) -> np.ndarray:
        a = np.asarray(avg, dtype=np.float64)
        w = np.log2(np.maximum(np.asarray(workers, dtype=np.float64), 1.0))
        return np.stack([np.ones_like(a), a, w, a * w, a * a, w * w], axis=-1)

    def __init__(self, store: RecordStore, pr: int = 0,
                 backend: Optional[str] = None):
        self.coeffs: Dict[str, np.ndarray] = {}
        self.clip: Dict[str, Tuple[float, float]] = {}
        for k in store.kernels():
            pts = [(r.avg, r.workers, r.gflops) for r in store.records
                   if r.kernel == k and r.pr == pr
                   and _of_backend(r, backend)]
            if len(pts) < 2:
                continue
            arr = np.array(pts, dtype=np.float64)
            X = self._basis(arr[:, 0], arr[:, 1])
            y = arr[:, 2]
            self.coeffs[k], *_ = np.linalg.lstsq(X, y, rcond=None)
            self.clip[k] = (float(arr[:, 0].min()), float(arr[:, 0].max()))

    def predict(self, kernel: str, avg: float, workers: int) -> float:
        if kernel not in self.coeffs:
            return -np.inf
        lo, hi = self.clip[kernel]
        X = self._basis(np.array([min(max(avg, lo), hi)]),
                        np.array([workers]))
        return float((X @ self.coeffs[kernel])[0])


def matrix_features(csr: CSRMatrix,
                    kernels: Sequence[str] = DEFAULT_KERNELS
                    ) -> Dict[str, float]:
    """Avg NNZ/block per kernel, computed from CSR without conversion."""
    feats: Dict[str, float] = {}
    cache: Dict[Tuple[int, int], float] = {}
    for k in kernels:
        rc = kernel_block(k)
        if rc not in cache:
            _, avg = block_stats(csr, *rc)
            cache[rc] = avg
        feats[k] = cache[rc]
    return feats


def select_kernel(csr: CSRMatrix, store: RecordStore, workers: int = 1,
                  kernels: Sequence[str] = DEFAULT_KERNELS, pr: int = 0,
                  backend: Optional[str] = None
                  ) -> Tuple[str, float, Dict[str, float]]:
    """Pick the kernel with the highest predicted throughput.

    ``pr`` selects which layout's records to fit (0 = whole-vector),
    ``backend`` which device's (None: every record).
    Returns (kernel, predicted_gflops, per-kernel predictions).
    """
    feats = matrix_features(csr, kernels)
    if workers == 1:
        pred = SequentialPredictor(store, pr=pr, backend=backend)
        scores = {k: pred.predict(k, feats[k]) for k in kernels}
    else:
        pred = ParallelPredictor(store, pr=pr, backend=backend)
        scores = {k: pred.predict(k, feats[k], workers) for k in kernels}
    best = max(scores, key=lambda k: scores[k])
    return best, scores[best], scores


# ----------------------------------------------------------------------------
# Configuration auto-tuning (layout, pr, xw, cb) from recorded runs
# ----------------------------------------------------------------------------

class ConfigPredictor:
    """Per-configuration throughput interpolation over matrix features.

    The paper's selector interpolates per-*kernel* throughput over one
    feature (Avg NNZ/block); panel geometry adds more knobs, and records are
    sparse in the larger space, so a polynomial per config would be badly
    conditioned. Instead each recorded configuration keeps its raw
    (feature-vector, gflops) points and queries use inverse-distance-weighted
    k-NN in the normalised feature space -- "simple interpolation of results
    from previous executions", per the paper, generalised to 4 dims
    (avg, log nnz/row, log bandwidth, log2 workers).
    """

    def __init__(self, store: RecordStore, kernel: Optional[str] = None,
                 k: int = 3, backend: Optional[str] = None):
        self.k = k
        self.points: Dict[PanelConfig, Tuple[np.ndarray, np.ndarray]] = {}
        grouped: Dict[PanelConfig, List[Tuple[np.ndarray, float]]] = {}
        all_vecs = []
        for r in store.records:
            if kernel is not None and r.kernel != kernel:
                continue
            if not _of_backend(r, backend):
                continue
            vec = r.features().vector(r.workers)
            grouped.setdefault(r.config(), []).append((vec, r.gflops))
            all_vecs.append(vec)
        if not all_vecs:
            self.scale = np.ones(4)
            return
        arr = np.asarray(all_vecs)
        # normalise each dimension by its spread so no single feature
        # dominates the distance; constant dimensions get scale 1
        std = arr.std(axis=0)
        self.scale = np.where(std > 1e-9, std, 1.0)
        for cfg, pts in grouped.items():
            X = np.asarray([p[0] for p in pts]) / self.scale
            y = np.asarray([p[1] for p in pts])
            self.points[cfg] = (X, y)

    def predict(self, feats: MatrixFeatures, config: PanelConfig,
                workers: int = 1) -> float:
        if config not in self.points:
            return -np.inf
        X, y = self.points[config]
        q = feats.vector(workers) / self.scale
        d = np.sqrt(((X - q[None, :]) ** 2).sum(axis=1))
        if float(d.min()) < 1e-12:          # exact feature match
            return float(y[d < 1e-12].mean())
        idx = np.argsort(d)[:min(self.k, d.shape[0])]
        w = 1.0 / d[idx]
        return float((w * y[idx]).sum() / w.sum())

    def configs(self) -> List[PanelConfig]:
        return list(self.points)


def tune(feats: MatrixFeatures, store: Optional[RecordStore] = None,
         kernel: Optional[str] = None, workers: int = 1,
         candidates: Optional[Sequence[PanelConfig]] = None,
         backend: Optional[str] = None) -> PanelConfig:
    """Pick the layout configuration with the highest predicted throughput.

    ``feats`` are the target matrix's features (:func:`csr_features` /
    :func:`spc5_features`); ``kernel`` restricts the fit to records of one
    block geometry (pass ``f"{r}x{c}"`` when the block is already fixed);
    ``candidates`` restricts the search to a subset of configurations
    (default: every configuration the store has measured).

    ``backend`` keeps one device's records (None: every record).

    Falls back to :data:`DEFAULT_CONFIG` when the store is missing, empty,
    or has no records for the requested kernel -- auto-tuning never makes a
    configuration *less* defined than the fixed defaults.
    """
    if store is None:
        store = get_default_store()
    if store is None or not store.records:
        return DEFAULT_CONFIG
    # cache the fitted predictor on the store: building one is O(n_records)
    # and models with many sparse layers call tune() per layer. The record
    # count keys invalidation (stores are append-only in practice), the
    # backend which records were fitted.
    cache = store.__dict__.setdefault("_predictor_cache", {})
    key = (kernel, len(store.records), backend)
    pred = cache.get(key)
    if pred is None:
        pred = cache[key] = ConfigPredictor(store, kernel=kernel,
                                            backend=backend)
    cfgs = list(candidates) if candidates is not None else pred.configs()
    cfgs = [c for c in cfgs if c in pred.points]
    if not cfgs:
        # no records for this kernel: fall back to kernel-agnostic records
        if kernel is not None:
            return tune(feats, store=store, kernel=None, workers=workers,
                        candidates=candidates, backend=backend)
        return DEFAULT_CONFIG
    scores = {c: pred.predict(feats, c, workers) for c in cfgs}
    best = max(scores, key=lambda c: scores[c])
    if not np.isfinite(scores[best]):
        return DEFAULT_CONFIG
    return best


def clamp_config(cfg: PanelConfig, *, nrows: int, ncols: int, r: int, c: int,
                 nblocks: int, align: int = 8) -> PanelConfig:
    """Validate a tuned configuration against a concrete matrix's dims.

    A store fitted on large matrices can propose panels taller than the
    matrix, x windows wider than its columns, or chunks larger than its
    block count; each is clamped to the matrix (keeping the layout's
    alignment invariants: pr a multiple of r, xw a multiple of ``align``
    with room for one block, cb >= 1). Only set fields are touched --
    zeros/None keep meaning "layout default".

    The ``lowering`` field is validated against the layout's registered
    variants: a config naming a lowering its layout did not register (a
    store fitted before a layout dropped its descriptor variant, or a
    future layout without one) falls back to "mask" -- the plan pipeline's
    tune pass records that demotion in ``plan.trace``.
    """
    pr, xw, cb = cfg.pr, cfg.xw, cfg.cb
    if pr:
        pr = max(r, min(pr, -(-nrows // r) * r))
    if xw:
        hi = -(-(ncols + align) // align) * align
        xw = max(c + align, min(xw, hi))
        xw = -(-xw // align) * align
    if cb:
        cb = max(1, min(cb, max(1, nblocks)))
    lowering = cfg.lowering
    if cfg.layout not in ("", "auto") and lowering not in ("", "auto"):
        from . import plan
        spec = plan._REGISTRY.get(plan.canonical_layout(cfg.layout))
        if spec is not None and lowering not in spec.lowerings:
            lowering = "mask"
    return PanelConfig(layout=cfg.layout, pr=pr, xw=xw, cb=cb,
                       reorder=cfg.reorder, lowering=lowering,
                       vdtype=cfg.vdtype)
