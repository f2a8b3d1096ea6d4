"""The port's training loss and gradients (``model.forward_loss`` under
``train.step.value_and_grad``) against the reference's
``jax.value_and_grad(model.forward_loss)`` on the CPU, the MoE
smoke configs, at each of the port's three remat policies; the harness
and its tolerance are in ``tests/torch_train_parity.py``."""
import pytest

from torch_train_parity import TOL, check_arch

ARCHS = [
    "phi3.5-moe-42b-a6.6b",
    "granite-moe-3b-a800m",
]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["nothing", "dots", "everything"])
def test_loss_and_grads_match_the_reference(arch, remat):
    assert check_arch(arch, remat) <= TOL
