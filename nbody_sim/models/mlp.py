"""Shared MLP block mirroring torch-geometric's ``MLP``: per hidden layer
Linear -> norm -> act -> dropout, plain final layer (PyG ``plain_last=True``
default), tanh activation.

The reference instantiates it twice with different norms: the GNN encoder
passes ``norm=None`` (``gnn.py:56-63``) while the ContConv encoder keeps PyG's
``batch_norm`` default (``contconv.py:135-141``) — both are supported here.
BatchNorm statistics are computed over exactly the *valid* nodes (torch's
BatchNorm1d sees only real nodes because PyG batches are unpadded); pass the
node mask through ``__call__`` when the batch carries padding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp


def torch_linear_init():
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — PyTorch ``nn.Linear`` default
    weight init (kaiming_uniform with a=sqrt(5)), so training dynamics track
    the reference."""
    return nn.initializers.variance_scaling(1.0 / 3.0, "fan_in", "uniform")


def _torch_bias_init(fan_in: int):
    """PyTorch ``nn.Linear`` default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)).

    flax's stock ``nn.Dense`` zero-initialises biases; the reference's layers
    start with uniform biases, which changes early training dynamics — this
    restores exact init-statistics parity (reference ``gnn.py:76-95`` edge
    MLPs, encoder/decoder Linears)."""
    bound = float(fan_in) ** -0.5

    def init(key, shape, dtype=jnp.float32):
        return jax.random.uniform(key, shape, dtype, -bound, bound)

    return init


class Dense(nn.Module):
    """Linear layer with full PyTorch ``nn.Linear`` init parity (uniform
    kernel *and* bias). Parameter names/shapes match ``nn.Dense`` so
    checkpoints are interchangeable."""

    features: int
    use_bias: bool = True

    @nn.compact
    def __call__(self, x):
        fan_in = x.shape[-1]
        kernel = self.param(
            "kernel", torch_linear_init(), (fan_in, self.features)
        )
        y = jnp.matmul(x, kernel)
        if self.use_bias:
            bias = self.param("bias", _torch_bias_init(fan_in), (self.features,))
            y = y + bias
        return y


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d whose batch statistics are computed over valid nodes only
    — the padded-batch equivalent of torch BatchNorm1d on PyG's *unpadded*
    node batch (reference ``contconv.py:135-141``). With ``mask=None`` it reduces over
    all leading axes, exactly like flax ``nn.BatchNorm``.

    Torch semantics mirrored: normalisation uses the biased batch variance,
    the running variance is updated with the unbiased estimate, and
    ``momentum=0.9`` here is flax decay convention (torch momentum 0.1).
    """

    momentum: float = 0.9
    epsilon: float = 1e-5

    @nn.compact
    def __call__(self, x, mask: Optional[jax.Array] = None, train: bool = False):
        f = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (f,))
        bias = self.param("bias", nn.initializers.zeros, (f,))
        ra_mean = self.variable(
            "batch_stats", "mean", lambda: jnp.zeros((f,), jnp.float32)
        )
        ra_var = self.variable(
            "batch_stats", "var", lambda: jnp.ones((f,), jnp.float32)
        )

        if train:
            xf = x.reshape(-1, f)
            if mask is not None:
                w = jnp.broadcast_to(
                    mask.astype(x.dtype)[..., None], x.shape
                ).reshape(-1, f)
                cnt = jnp.maximum(jnp.sum(w[:, 0]), 1.0)
                mean = jnp.sum(xf * w, axis=0) / cnt
                var = jnp.sum(w * (xf - mean) ** 2, axis=0) / cnt
            else:
                cnt = jnp.asarray(xf.shape[0], x.dtype)
                mean = jnp.mean(xf, axis=0)
                var = jnp.mean((xf - mean) ** 2, axis=0)
            if not self.is_initializing():
                unbiased = var * cnt / jnp.maximum(cnt - 1.0, 1.0)
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * unbiased
        else:
            mean, var = ra_mean.value, ra_var.value

        y = (x - mean) * jax.lax.rsqrt(var + self.epsilon)
        return y * scale + bias


class MLP(nn.Module):
    """features = hidden dims + output dim; input dim inferred.

    When ``norm == 'batch_norm'`` the module uses a ``batch_stats`` collection
    (mutable during training) like any flax BatchNorm model; pass ``mask``
    so padded nodes never enter the batch statistics.
    """

    features: Sequence[int]
    dropout: float = 0.0
    norm: Optional[str] = None  # None | "batch_norm"
    plain_last: bool = True

    @nn.compact
    def __call__(self, x, train: bool = False, mask: Optional[jax.Array] = None):
        n = len(self.features)
        for i, f in enumerate(self.features):
            x = Dense(f)(x)
            if not (self.plain_last and i == n - 1):
                if self.norm == "batch_norm":
                    x = MaskedBatchNorm()(x, mask=mask, train=train)
                x = jnp.tanh(x)
                if self.dropout > 0:
                    x = nn.Dropout(self.dropout, deterministic=not train)(x)
        return x


class OutputHead(nn.Module):
    """The reference's decoder head (``gnn.py:105-114``,
    ``contconv.py:207-216``): plain Linear when no hiddens, otherwise
    Linear/Tanh sandwiches with a plain final Linear (no norm, no dropout).

    ``zero_init`` zero-initialises the final Linear so the model starts at
    pred = 0. The targets (accelerations ~1e-7) are ~5 orders of magnitude
    below a torch-init network's output scale; the reference spends its first
    ~12 epochs collapsing that gap, which can drive BatchNorm biases into
    tanh saturation (observed as a constant-predictor collapse). Divergence
    from the reference's init, strictly better conditioning.
    """

    hiddens: Optional[Sequence[int]]
    output_dim: int
    zero_init: bool = False

    @nn.compact
    def __call__(self, x):
        if self.hiddens:
            for f in self.hiddens:
                x = jnp.tanh(Dense(f)(x))
        if self.zero_init:
            return nn.Dense(
                self.output_dim, kernel_init=nn.initializers.zeros
            )(x)
        return Dense(self.output_dim)(x)
