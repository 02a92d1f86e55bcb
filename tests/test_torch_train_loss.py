"""The port's ``train_loss`` and its gradients against the JAX reference's,
for every reduced architecture, on the CPU.

Weights are the reference's ``init_params(PRNGKey(0), cfg)`` bridged through
``weights.from_reference``; the batch comes from ``make_batches`` of both
packages (tokens, and frames for the enc-dec stack, asserted bit-equal).
The reference's loss runs its XLA path, the port's its plain versions.

Tolerances: the loss at rtol 2e-4 / atol 1e-5 (ROADMAP "held against the
reference"); each gradient leaf, by path, at max|port - ref| <= atol + rtol
* max|ref| over the leaf, with atol 1e-5 and rtol 2e-4.  zamba2 (ROADMAP
C2): atol 1e-4 and rtol 1e-3.  Its gradients are ill-conditioned in f32:
against a float64 evaluation of the same function, the reference's f32
gradients sit up to 1.1e-4 of the leaf's scale off and the port's up to
2.9e-4 (the token embedding, the Mamba conv weights and norms, which the
SSD's chunk decays feed), and the two differ by up to 4.0e-4
(``scripts/f64_grads.py --reference zamba2_7b``).  Remat on and off run
the same ops, recomputed or kept, so they must agree exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_reduced_config
from repro.data import make_batches as r_make_batches
from repro.models import NULL_SH, init_params
from repro.models.model import train_loss as r_train_loss
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.data import make_batches as t_make_batches
from repro_torch.models import train_loss
from repro_torch.training.optimizer import tree_items, tree_leaves, tree_map
from repro_torch.weights import from_reference

torch.set_num_threads(1)

B, S = 2, 16
# (atol, rtol) of a gradient leaf, relative to the leaf's max |ref|
GRAD_TOL = {"zamba2_7b": (1e-4, 1e-3)}


@functools.lru_cache(maxsize=None)
def setup(arch):
    cfg = get_reduced_config(arch)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(np.asarray, params)
    rb = next(r_make_batches(cfg, B, S, seed=0))
    tb = next(t_make_batches(t_get_reduced_config(arch), B, S, seed=0))
    assert rb.keys() == tb.keys()
    for k in rb:
        assert rb[k].dtype == tb[k].dtype
        np.testing.assert_array_equal(rb[k], tb[k])
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: r_train_loss(p, cfg, NULL_SH,
                               {k: jnp.asarray(v) for k, v in rb.items()},
                               remat=True), has_aux=True)(params)
    ref = (float(loss), {k: float(v) for k, v in metrics.items()},
           dict(tree_items(jax.tree.map(np.asarray, grads))))
    return np_params, tb, ref


def port_loss_and_grads(arch, remat):
    np_params, tb, _ = setup(arch)
    live = tree_map(lambda p: p.requires_grad_(True),
                    from_reference(np_params, "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in tb.items()}
    loss, metrics = train_loss(live, t_get_reduced_config(arch), batch,
                               remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                materialize_grads=True)
    paths = [p for p, _ in tree_items(live)]
    return loss.detach(), metrics, dict(zip(paths, grads))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_grads_match_reference(arch):
    r_loss, r_metrics, r_grads = setup(arch)[2]
    loss, metrics, grads = port_loss_and_grads(arch, remat=True)
    np.testing.assert_allclose(float(loss), r_loss, rtol=2e-4, atol=1e-5)
    assert metrics.keys() == r_metrics.keys()
    for k, v in r_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), v, rtol=2e-4,
                                   atol=1e-5, err_msg=k)
    assert grads.keys() == r_grads.keys()
    atol, rtol = GRAD_TOL.get(arch, (1e-5, 2e-4))
    for path, want in r_grads.items():
        got = grads[path].numpy()
        assert got.shape == want.shape, path
        if want.size == 0:
            continue
        err = float(np.max(np.abs(got - want)))
        bound = atol + rtol * float(np.max(np.abs(want)))
        assert err <= bound, (path, err, bound)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_on_equals_off(arch):
    loss_on, m_on, g_on = port_loss_and_grads(arch, remat=True)
    loss_off, m_off, g_off = port_loss_and_grads(arch, remat=False)
    assert torch.equal(loss_on, loss_off)
    for k in m_on:
        assert torch.equal(m_on[k].detach(), m_off[k].detach()), k
    for path in g_on:
        assert torch.equal(g_on[path], g_off[path]), path


def _kernel_calls():
    """(name, wrapper call on tensors from ``make(shape)``) of K1-K4 at
    small shapes."""
    from repro_torch.kernels import decode_attention, flash_attention, ssd, \
        wkv6

    return {
        "K1": ("decode_attention", lambda t: decode_attention(
            t(2, 1, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16), 3)),
        "K2": ("flash_attention", lambda t: flash_attention(
            t(2, 8, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16))),
        "K3": ("wkv6", lambda t: wkv6(t(2, 8, 2, 16), t(2, 8, 2, 16),
                                      t(2, 8, 2, 16), -t(2, 8, 2, 16).abs(),
                                      t(2, 16))),
        "K4": ("ssd", lambda t: ssd(t(2, 8, 2, 16), t(2, 8, 16),
                                    t(2, 8, 16), t(2, 8, 2).abs(),
                                    -t(2).abs(), t(2))),
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_kernel_wrappers_refuse_grad(kernel):
    """A kernel call that autograd records on an input requiring grad
    raises, naming the kernel (meta tensors take the kernel branch here,
    as CUDA tensors do on the card); under no_grad the same call reaches
    the device check; on the CPU the plain version runs and
    differentiates."""
    name, call = _kernel_calls()[kernel]

    def meta(*shape):
        return torch.zeros(shape, device="meta", requires_grad=True)

    with pytest.raises(RuntimeError, match=f"{name} \\({kernel}\\).*no "
                       "backward"):
        call(meta)
    with torch.no_grad(), pytest.raises(ValueError, match="device meta"):
        call(meta)
    gen = torch.Generator().manual_seed(0)
    leaves = []

    def cpu(*shape):
        leaves.append(torch.randn(shape, generator=gen).requires_grad_(True))
        return leaves[-1]

    out = call(cpu)
    out = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(out.sum(), leaves[:3])
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
