"""Shared by the ``tests/test_torch_train_loss*.py`` files: one arch's
training loss and gradients in the port against the reference's
``jax.value_and_grad(model.forward_loss)`` on the CPU.

Both packages get the reference's parameters (``jax.random.PRNGKey``,
carried leaf for leaf by ``convert.params_from_numpy``) and one
``SyntheticLM`` batch, byte-equal in both. Tolerance: the loss and each
metric within ``TOL`` of itself, each gradient leaf within ``TOL`` of the
leaf's max|g| (both packages sum the same products in other orders; the
worst measured is 3.2e-6, mamba2's ``dt_bias``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.models import model as JMD
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import convert as CV
from repro_torch.train.loop import device_batch
from repro_torch.train.step import value_and_grad

TOL = 1e-5
SEQ, BATCH = 32, 2


def flat(tree, pre=""):
    """{"path/to/leaf": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


def grads_close(got, ref, tol=TOL):
    """Each leaf of ``got`` (tensors) within ``tol`` of its max|ref|;
    returns the worst ratio."""
    got, ref = flat(got), flat(jax.tree.map(np.asarray, ref))
    assert set(got) == set(ref)
    worst = 0.0
    for path, r in ref.items():
        g = got[path].detach().numpy()
        assert g.dtype == np.float32 and g.shape == r.shape, path
        m = float(np.abs(r).max())
        err = float(np.abs(g - r).max())
        assert err <= tol * m or (m == 0 and err == 0), (path, err, m)
        worst = max(worst, err / m if m else 0.0)
    return worst


@functools.lru_cache(maxsize=None)
def reference(arch, seed=1, step=0):
    """(the reference's params, its batch, (loss, metrics), grads), jitted
    once an arch."""
    cfg = ref_smoke_config(arch)
    params = JMD.init_params(cfg, jax.random.PRNGKey(seed))
    batch = JSyntheticLM(cfg, SEQ, BATCH, seed=seed).batch(step)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JMD.forward_loss(p, b, cfg), has_aux=True))
    out = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return params, batch, out


def port(arch, params, batch, remat="nothing"):
    """The port's ((loss, metrics), grads) on the reference's params and a
    batch of its own ``SyntheticLM``."""
    cfg = get_smoke_config(arch)
    tp = CV.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    own = SyntheticLM(cfg, SEQ, BATCH, seed=1).batch(0)
    for k in batch:
        assert own[k].tobytes() == batch[k].tobytes()
    return value_and_grad(cfg, remat)(tp, device_batch(own, "cpu"))


def check_arch(arch, remat="nothing"):
    """The port's loss, metrics and gradients under ``remat`` against the
    reference's (under its default policy: remat changes what is saved,
    not the numbers)."""
    params, batch, ((jl, jm), jg) = reference(arch)
    (tl, tm), tg = port(arch, params, batch, remat)
    assert set(tm) == set(jm)
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= TOL * abs(float(jm[k])) \
            + 1e-12, k
    return grads_close(tg, jg)
