"""SparseLinear: a pruned weight matrix in beta(r,c) as a PyTorch layer.

The port's counterpart of ``repro.core.sparse_linear``: ``y = W_sparse @ x``
over batched activations is the paper's SpMM, batch-1 decode its SpMV. The
block geometry comes from the paper's selector where a record store holds
measurements of the layer's device, else from the eq.-4 breakeven. The
layer runs forward only: the reference defines no gradient for it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops

from . import formats as F
from . import plan as P
from . import ref_spmv as R
from . import selector as S


def prune_by_magnitude(w: np.ndarray, density: float) -> np.ndarray:
    """Keep the top ``density`` fraction of |w| entries (global threshold)."""
    if density >= 1.0:
        return w
    k = max(1, int(w.size * density))
    thresh = np.partition(np.abs(w).ravel(), w.size - k)[w.size - k]
    return np.where(np.abs(w) >= thresh, w, 0.0)


def choose_block(csr: F.CSRMatrix, store: Optional[S.RecordStore] = None,
                 workers: int = 1, *,
                 device: Optional[P.Device] = None) -> Tuple[int, int]:
    """Selector-driven (r, c) choice, as in the reference: the kernel
    ``selector.select_kernel`` predicts fastest from ``store``'s records of
    ``device``'s backend (resolved as ``ops.resolve_device`` does, and read
    only for its backend); without such a record (no store, an empty one,
    or one of other devices), the eq.-4 breakeven argmax: the (r, c) whose
    Avg(r,c) most exceeds the paper's breakeven filling."""
    if store is not None and store.records:
        backend = S.backend_of(ops.resolve_device(device))
        if S.has_backend(store, backend):
            kernel, _, _ = S.select_kernel(csr, store, workers=workers,
                                           backend=backend)
            return S.kernel_block(kernel)
    best, best_score = (1, 8), -np.inf
    for (r, c) in F.SUPPORTED_BLOCKS:
        _, avg = F.block_stats(csr, r, c)
        # margin over the paper's breakeven filling, normalised by block area
        score = avg / F.beta_breakeven_avg(r, c)
        if score > best_score:
            best, best_score = (r, c), score
    return best


def _bias_tensor(bias, device: torch.device) -> Optional[torch.Tensor]:
    # float32, as the reference's jnp.asarray stores it
    return None if bias is None else R.to_tensor(np.asarray(bias), device)


class SparseLinear(nn.Module):
    """y = A x (+ b) with A stored in chunked beta(r,c).

    ``plan`` is an execution plan (:class:`repro_torch.core.plan.SPC5Plan`)
    in whichever layout the plan passes selected; ``plan.trace`` records
    every decision. The layer has no parameters and a ``bias`` buffer
    (``None`` without a bias). The plan's tensors live on the device it was
    built for; ``.to()`` moves only the bias, so build the layer where it
    will run."""

    def __init__(self, plan: P.SPC5Plan,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.plan = plan
        self.register_buffer("bias", bias)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.plan.shape

    @property
    def density(self) -> float:
        return self.plan.nnz / (self.shape[0] * self.shape[1])

    @classmethod
    def from_dense(cls, w: np.ndarray, density: float = 1.0,
                   block: Optional[Tuple[int, int]] = None, store=None,
                   bias: Optional[np.ndarray] = None,
                   cb: Optional[int] = None, dtype=None,
                   vdtype: str = "auto", layout: str = "auto",
                   pr: Optional[int] = None, xw: Optional[int] = None,
                   nvec: int = 128, tune: bool = True, reorder=None,
                   lowering: str = "auto", verify=False, *,
                   device: Optional[P.Device] = None) -> "SparseLinear":
        """Prune ``w`` (d_out, d_in) to ``density``, convert it to
        beta(``block``) (default: :func:`choose_block`) and build its plan
        on ``device`` (default: the card).

        ``nvec`` is the widest activation batch the layer will see; it feeds
        the "auto" layout's budget exactly as in the reference (default 128,
        one full SpMM tile). ``layout="test"`` builds the beta(r,c)_test
        split (its multi sub-plan's layout by the "auto" rule).
        ``lowering`` ("mask" | "descriptor" | "auto", the default) picks
        the kernel variant and ``vdtype`` ("f32" | "bf16" | "int8" |
        "auto") the stored values exactly as on
        :func:`repro_torch.kernels.ops.prepare` (the forward returns f32
        either way). ``reorder`` (a strategy name, or a Reordering: the
        port's or the reference's) permutes the pruned weight before the
        layout is built; activations go in and come out in the original
        feature order. The record ``store`` drives the block choice
        (:func:`choose_block`) and the plan's tuning (``ops.prepare``), from
        its records of ``device``'s backend only; ``verify`` is the static
        verifier's hook, as on ``ops.prepare``."""
        w = prune_by_magnitude(np.asarray(w), density)
        csr = F.csr_from_dense(w)
        if block is None:
            block = choose_block(csr, store, device=device)
        mat = F.csr_to_spc5(csr, *block)
        plan = ops.prepare(mat, cb=cb, dtype=dtype, vdtype=vdtype,
                           layout=layout, pr=pr, xw=xw, nvec=nvec,
                           store=store, tune=tune, reorder=reorder,
                           lowering=lowering, verify=verify, device=device)
        return cls(plan, _bias_tensor(bias, plan.device))

    @classmethod
    def from_arrays(cls, layout, arrays=None, meta=None, bias=None, *,
                    device: P.Device, children=(), col_perm=None,
                    row_iperm=None, rows_fused: bool = False
                    ) -> "SparseLinear":
        """A layer over another plan's host arrays and geometry, so the port
        computes with exactly the bytes the other package built
        (:func:`repro_torch.core.plan.plan_from_arrays`): e.g. a JAX
        ``SparseLinear``'s ``handle`` whole (``from_arrays(handle,
        bias=bias)``), or its ``handle.layout``, ``handle.arrays``,
        ``handle.meta`` with its ``col_perm``, ``row_iperm`` and
        ``rows_fused`` (for a test plan also ``children=[handle.multi]``):
        a reordered layer computes the reference's product only with its
        permutations, which come with the plan whole."""
        plan = P.plan_from_arrays(layout, arrays, meta, device=device,
                                  children=children, col_perm=col_perm,
                                  row_iperm=row_iperm, rows_fused=rows_fused)
        return cls(plan, _bias_tensor(bias, plan.device))

    def forward(self, x: torch.Tensor, *, use_pallas: Optional[bool] = None,
                interpret: Optional[bool] = None) -> torch.Tensor:
        """x: (..., d_in) -> (..., d_out). A batch of one goes to SpMV, a
        wider batch to SpMM on a contiguous (d_in, batch) copy of x.
        ``use_pallas=False`` runs the plain PyTorch versions on the plan's
        device; ``interpret`` as on ``ops.spmv``."""
        d_in = self.plan.ncols
        lead = x.shape[:-1]
        xf = x.reshape(-1, d_in)                        # (batch, d_in)
        kw = dict(use_pallas=use_pallas, interpret=interpret)
        if xf.shape[0] == 1:
            y = ops.spmv(self.plan, xf[0].contiguous(), **kw)[None, :]
        else:
            y = ops.spmm(self.plan, xf.t().contiguous(), **kw).t()
        y = y.reshape(*lead, self.plan.nrows)
        if self.bias is not None:
            y = y + self.bias
        return y
