"""Variational autoencoder (``v1_api_demo/vae``): the port of
``paddle_tpu/models/vae.py``.

Encoder fc → (mu, logvar) → the reparameterised sample (``sample_gaussian``)
→ decoder fc → sigmoid reconstruction. The objective, reconstruction
cross-entropy + KL(q || N(0, I)), is two cost layers trained on their sum.
"""

from __future__ import annotations

from paddle_tpu_torch.config import dsl
from paddle_tpu_torch.config.model_config import Input, LayerDef


def _raw_layer(name, type_, inputs, **attrs):
    ld = LayerDef(name=name, type=type_,
                  inputs=[Input(i.name) for i in inputs], bias=False,
                  attrs=attrs)
    return dsl._add(ld)


def vae(*, data_dim: int = 784, hidden: int = 256, latent: int = 32):
    """Returns (costs, reconstruction, data_names). Train with
    ``SGD(cost=Topology(costs))``: the trainer sums both costs."""
    x = dsl.data(name="x", size=data_dim)
    h = dsl.fc(input=x, size=hidden, act="relu", name="enc_h")
    mu = dsl.fc(input=h, size=latent, act="linear", name="enc_mu")
    logvar = dsl.fc(input=h, size=latent, act="linear", name="enc_logvar")
    z = _raw_layer("z", "sample_gaussian", [mu, logvar])
    dh = dsl.fc(input=z, size=hidden, act="relu", name="dec_h")
    recon = dsl.fc(input=dh, size=data_dim, act="sigmoid", name="recon")
    recon_cost = _raw_layer("recon_cost", "multi_binary_label_cross_entropy",
                            [recon, x])
    kl_cost = _raw_layer("kl_cost", "kl_gaussian", [mu, logvar])
    return [recon_cost, kl_cost], recon, ["x"]


def vae_decoder(*, data_dim: int = 784, hidden: int = 256,
                latent: int = 32):
    """The generating graph: z → reconstruction, sharing the decoder's
    parameters (``_dec_h.*``, ``_recon.*``) with the trained model."""
    z = dsl.data(name="z", size=latent)
    dh = dsl.fc(input=z, size=hidden, act="relu", name="dec_h")
    return dsl.fc(input=dh, size=data_dim, act="sigmoid", name="recon")
