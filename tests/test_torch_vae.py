"""The VAE (``models/vae.py``, ``v1_api_demo/vae``) in the port against
the JAX package, on the CPU: the same graph and parameter names; with
JAX's ε replayed through ``layers/sampling.py:_gaussian_eps`` both costs
and every gradient as JAX's (values rtol 1e-5 / atol 1e-5, gradients rtol
1e-4 / atol 1e-5); the twin of ``tests/test_gan_vae.py``'s training run
with the port's own draws, and the decoder graph sharing the trained
parameters by name.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.models import vae as jvae
from paddle_tpu.trainer.trainer import SGD as JSGD, Topology as JTopology
from paddle_tpu.optim import Adam as JAdam
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.layers import sampling
from paddle_tpu_torch.models import vae as tvae, vae_decoder
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.trainer import events as tev
from paddle_tpu_torch.trainer.trainer import SGD, Topology

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
DIMS = dict(data_dim=32, hidden=32, latent=8)


def test_vae_costs_and_gradients_match_jax_with_eps_replayed(monkeypatch):
    key = jax.random.PRNGKey(5)
    jdsl.reset()
    jcosts, _, _ = jvae(**DIMS)
    jtr = JSGD(cost=JTopology(jcosts), update_equation=JAdam(), seed=3)
    tdsl.reset()
    tcosts, _, names = tvae(**DIMS)
    assert names == ["x"]
    params = {k: np.array(v) for k, v in jtr.params.items()}
    ttr = SGD(Topology(tcosts), parameters=params, update_equation=Adam(),
              device="cpu")
    assert sorted(ttr.params) == sorted(params)
    x = (np.random.default_rng(0).random((16, 32)) > 0.5).astype(np.float32)

    def eps(shape, dtype, ctx, name, device):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, zlib.crc32(name.encode())),
            tuple(shape), jnp.float32)))
    monkeypatch.setattr(sampling, "_gaussian_eps", eps)

    def jloss(p):
        outs = jtr.network.apply(p, {"x": JArgument(jnp.asarray(x))},
                                 train=True, rng=key)
        return (jnp.sum(outs["recon_cost"].value) / 16
                + jnp.sum(outs["kl_cost"].value) / 16,
                (outs["recon_cost"].value, outs["kl_cost"].value))

    (_, (jr, jk)), jg = jax.value_and_grad(jloss, has_aux=True)(jtr.params)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    outs = ttr.network.apply(tp, {"x": TArgument(torch.from_numpy(x))},
                             train=True, seed=0)
    np.testing.assert_allclose(outs["recon_cost"].value.detach().numpy(),
                               np.asarray(jr), **FWD_TOL)
    np.testing.assert_allclose(outs["kl_cost"].value.detach().numpy(),
                               np.asarray(jk), **FWD_TOL)
    loss = (outs["recon_cost"].value.sum() + outs["kl_cost"].value.sum()) / 16
    names = sorted(tp)
    for n, g in zip(names, torch.autograd.grad(loss, [tp[k] for k in names])):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), **GRAD_TOL,
                                   err_msg=n)


def test_vae_trains_and_generates():
    """Twin of ``tests/test_gan_vae.py``: the summed ELBO cost falls by a
    fifth over 6 passes; the decoder graph's parameters are the trained
    ones by name, and it produces values in [0, 1] from z."""
    tdsl.reset()
    costs, recon, _ = tvae(**DIMS)
    tr = SGD(Topology(costs), update_equation=Adam(learning_rate=2e-3),
             device="cpu")
    rng = np.random.RandomState(0)
    proto = (rng.rand(4, 32) > 0.5).astype(np.float32)

    def reader():
        for _ in range(8):
            x = proto[rng.randint(0, 4, size=16)]
            flip = rng.rand(16, 32) < 0.05
            yield {"x": TArgument(torch.from_numpy(
                np.where(flip, 1 - x, x).astype(np.float32)))}

    cs = []
    tr.train(reader, num_passes=6,
             event_handler=lambda e: cs.append(e.cost)
             if isinstance(e, tev.EndIteration) else None)
    assert cs[-1] < cs[0] * 0.8
    tdsl.reset()
    out = vae_decoder(**DIMS)
    net = TNetwork(tdsl.current_graph(), outputs=[out.name])
    assert set(net.param_specs) <= set(tr.params)
    z = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
    v = net.apply(tr.params, {"z": TArgument(z)})[out.name].value
    assert tuple(v.shape) == (5, 32) and v.min() >= 0 and v.max() <= 1
