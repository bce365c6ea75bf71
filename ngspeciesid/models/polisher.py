"""Neural pileup polisher — the learned medaka-class head (N6 in SURVEY.md).

The reference shells out to medaka (a TensorFlow RNN over pileup counts,
consensus.py:94-105).  Our deterministic quality-weighted pileup caller
(ops/poa.py:polish_round) already reaches template-exact consensus at
amplicon depth; this model is the learned upgrade path for lower-depth or
biased-error regimes, and the framework's flagship jittable network.

Architecture: per-position pileup features -> input projection -> a
bidirectional GRU over the sequence axis -> 5-way symbol head
(A, C, G, T, deletion).  Written in pure JAX with an explicit parameter
pytree so tensor-parallel sharding is first-class: hidden dimensions carry a
named 'model' axis (see ``param_shardings``), the sequence scan is a
``lax.scan``, and the whole train step jits under a (data, model) mesh —
XLA inserts the all-reduces for the hidden-dim contractions.

Pileup features (N_FEATURES per position): base counts (4), deletion count,
quality-weighted base counts (4), insertion-open count, coverage, draft base
one-hot (4), bias.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import PartitionSpec as P

N_FEATURES = 16
N_CLASSES = 5  # A C G T deletion
HIDDEN = 128


def init_params(key: jax.Array, hidden: int = HIDDEN) -> Dict:
    k = jax.random.split(key, 8)
    scale = 0.08
    def mat(kk, shape):
        return scale * jax.random.normal(kk, shape, dtype=jnp.float32)
    return {
        "embed": mat(k[0], (N_FEATURES, hidden)),
        "fwd": {
            "wx": mat(k[1], (hidden, 3 * hidden)),
            "wh": mat(k[2], (hidden, 3 * hidden)),
            "b": jnp.zeros((3 * hidden,), jnp.float32),
        },
        "bwd": {
            "wx": mat(k[3], (hidden, 3 * hidden)),
            "wh": mat(k[4], (hidden, 3 * hidden)),
            "b": jnp.zeros((3 * hidden,), jnp.float32),
        },
        "out_w": mat(k[5], (2 * hidden, N_CLASSES)),
        "out_b": jnp.zeros((N_CLASSES,), jnp.float32),
    }


def param_shardings() -> Dict:
    """PartitionSpecs for tensor parallelism over the 'model' mesh axis."""
    return {
        "embed": P(None, "model"),
        "fwd": {"wx": P(None, "model"), "wh": P(None, "model"), "b": P("model")},
        "bwd": {"wx": P(None, "model"), "wh": P(None, "model"), "b": P("model")},
        "out_w": P("model", None),
        "out_b": P(None),
    }


def _mm(a, b):
    """float32 product at full precision: GPUs would otherwise run it in
    TF32, and the calls must not depend on the device."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _gru_scan(cell_params: Dict, xs: jnp.ndarray) -> jnp.ndarray:
    """xs: (L, B, H) -> hidden states (L, B, H)."""
    H = cell_params["wh"].shape[0]
    wx, wh, b = cell_params["wx"], cell_params["wh"], cell_params["b"]

    def step(h, x):
        gx = _mm(x, wx) + b      # (B, 3H)
        gh = _mm(h, wh)          # (B, 3H)
        z = jax.nn.sigmoid(gx[:, :H] + gh[:, :H])
        r = jax.nn.sigmoid(gx[:, H : 2 * H] + gh[:, H : 2 * H])
        n = jnp.tanh(gx[:, 2 * H :] + r * gh[:, 2 * H :])
        h_new = (1.0 - z) * n + z * h
        return h_new, h_new

    h0 = jnp.zeros((xs.shape[1], H), xs.dtype)
    _, hs = jax.lax.scan(step, h0, xs)
    return hs


def forward(params: Dict, features: jnp.ndarray) -> jnp.ndarray:
    """features: (B, L, N_FEATURES) -> logits (B, L, N_CLASSES)."""
    x = _mm(features, params["embed"])      # (B, L, H)
    xs = jnp.swapaxes(x, 0, 1)              # (L, B, H)
    h_fwd = _gru_scan(params["fwd"], xs)
    h_bwd = _gru_scan(params["bwd"], xs[::-1])[::-1]
    h = jnp.concatenate([h_fwd, h_bwd], axis=-1)    # (L, B, 2H)
    logits = _mm(h, params["out_w"]) + params["out_b"]
    return jnp.swapaxes(logits, 0, 1)


def loss_fn(params: Dict, features: jnp.ndarray, labels: jnp.ndarray,
            mask: jnp.ndarray) -> jnp.ndarray:
    logits = forward(params, features)
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    return (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)


def make_train_step(optimizer: optax.GradientTransformation):
    def train_step(params, opt_state, features, labels, mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, features, labels, mask)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss
    return train_step


@functools.partial(jax.jit, static_argnames=())
def _forward_jit(params, feats):
    return forward(params, feats)


def neural_polish_round(params, center: np.ndarray, reads, quals) -> np.ndarray:
    """Medaka-class neural polishing: pileup features -> GRU -> per-position
    symbol call (A/C/G/T/deletion); insertions come from the pileup majority
    rule (same as ops/poa.polish_round).  Uncovered positions keep the draft.
    """
    from ..ops.poa import pileup_stats  # local import: avoid cycle

    if not reads or center.size == 0:
        return center
    st = pileup_stats(center, reads, quals)
    feats = pileup_features(center, st.votes, st.qvotes, st.ins_open, st.coverage)
    L = center.size
    Lp = -(-L // 256) * 256  # fixed-shape buckets keep compiles bounded
    fpad = np.zeros((1, Lp, N_FEATURES), dtype=np.float32)
    fpad[0, :L] = feats
    logits = np.asarray(_forward_jit(params, jnp.asarray(fpad)))[0, :L]
    cls = logits.argmax(axis=1)
    out = []
    cov = st.coverage
    base_bytes = np.frombuffer(b"ACGT", dtype=np.uint8)
    for p in range(L + 1):
        if st.ins_votes[p]:
            total_ins = sum(st.ins_votes[p].values())
            if total_ins > cov[p] / 2.0:
                best = sorted(st.ins_votes[p].items(), key=lambda kv: (-kv[1], kv[0]))[0]
                out.extend(best[0])
        if p < L:
            if st.votes[p].sum() == 0.0:
                out.append(int(center[p]))
            elif cls[p] < 4:
                out.append(int(base_bytes[cls[p]]))
            # cls 4 = deletion: emit nothing
    return np.array(out, dtype=np.uint8)


def pileup_features(
    center: np.ndarray, votes: np.ndarray, qvotes: np.ndarray,
    ins_open: np.ndarray, coverage: np.ndarray,
) -> np.ndarray:
    """Assemble the (L, N_FEATURES) tensor from pileup statistics."""
    L = center.size
    feats = np.zeros((L, N_FEATURES), dtype=np.float32)
    feats[:, 0:5] = votes
    feats[:, 5:9] = qvotes[:, :4]
    feats[:, 9] = ins_open[:L]
    feats[:, 10] = coverage[:L]
    for i, b in enumerate(b"ACGT"):
        feats[:, 11 + i] = center == b
    feats[:, 15] = 1.0
    denom = np.maximum(coverage[:L], 1.0)[:, None]
    feats[:, 0:5] /= denom
    feats[:, 5:9] /= denom
    feats[:, 9] /= denom[:, 0]
    feats[:, 10] = np.log1p(feats[:, 10])
    return feats
