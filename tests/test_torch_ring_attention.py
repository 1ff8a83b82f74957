"""``pathway_tpu_torch/parallel/ring_attention.py`` against the JAX
package's: the same numpy inputs through JAX's ``ring_attention`` on the
8 virtual CPU devices and through the port's on a mesh of ``["cpu"] * 8``,
at the reference test's tolerances (2e-5 in f32, 5e-2 in bf16)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from pathway_tpu.parallel.ring_attention import (
    reference_attention as jax_reference_attention,
    ring_attention as jax_ring_attention,
)
from pathway_tpu_torch.parallel import make_mesh
from pathway_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_attention,
)


def _jax_mesh(shape, names):
    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs 8 virtual devices (conftest sets XLA_FLAGS)")
    devs = np.array(jax.devices("cpu")[: int(np.prod(shape))]).reshape(shape)
    return JaxMesh(devs, names)


def _qkv(seed, b=2, h=4, s=64, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


def _both(arrays, bf16=False):
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(causal):
    jm = _jax_mesh((8,), ("sp",))
    (jq, jk, jv), (q, k, v) = _both(_qkv(0))
    want = jax_ring_attention(jq, jk, jv, jm, causal=causal)
    got = ring_attention(q, k, v, make_mesh(devices=["cpu"] * 8, axes=("sp",)),
                         causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _np(got), _np(reference_attention(q, k, v, causal=causal)), rtol=2e-5, atol=2e-5)


def test_ring_composes_with_dp():
    jm = _jax_mesh((2, 4), ("dp", "sp"))
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, b=4, s=32))
    want = jax_ring_attention(jq, jk, jv, jm, axis="sp", causal=True)
    mesh = make_mesh(devices=["cpu"] * 8, axes=("dp", "sp"), shape=(2, 4))
    got = ring_attention(q, k, v, mesh, axis="sp", causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_ring_bf16_long_sequence():
    """S = 2048 over 8 devices in bf16: score blocks of 256², not 2048²."""
    jm = _jax_mesh((8,), ("sp",))
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, b=1, h=2, s=2048, d=32), bf16=True)
    want = jax_ring_attention(jq, jk, jv, jm, causal=True)
    got = ring_attention(q, k, v, make_mesh(devices=["cpu"] * 8, axes=("sp",)),
                         causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=5e-2, atol=5e-2)


def test_ring_handles_uneven_softmax_rows():
    """One position per device: the first causal query block attends to a
    single key, and the fully-masked-row guards must not NaN."""
    jm = _jax_mesh((8,), ("sp",))
    (jq, jk, jv), (q, k, v) = _both(_qkv(3, b=1, h=1, s=8, d=4))
    got = ring_attention(q, k, v, make_mesh(devices=["cpu"] * 8, axes=("sp",)),
                         causal=True)
    assert not torch.isnan(got).any()
    want = jax_ring_attention(jq, jk, jv, jm, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,bf16", [(False, False), (True, False), (True, True)])
def test_reference_attention_matches_jax(causal, bf16):
    (jq, jk, jv), (q, k, v) = _both(_qkv(4, b=2, h=3, s=48, d=8), bf16=bf16)
    got = reference_attention(q, k, v, causal=causal)
    want = jax_reference_attention(jq, jk, jv, causal=causal)
    assert got.dtype == q.dtype
    tol = 5e-2 if bf16 else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_sequence_not_divisible_by_the_axis_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, s=60))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(q, k, v, make_mesh(devices=["cpu"] * 8, axes=("sp",)))


def test_ring_of_one_device_is_full_attention():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6))
    got = ring_attention(q, k, v, make_mesh(devices=["cpu"], axes=("sp",)), causal=True)
    np.testing.assert_allclose(
        _np(got), _np(reference_attention(q, k, v, causal=True)), rtol=2e-5, atol=2e-5)


def test_ring_on_a_card_mesh_refuses_to_drop_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card is valid")
    q, k, v = (torch.from_numpy(a) for a in _qkv(7))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ring_attention(q, k, v, make_mesh(devices=["cuda:0"] * 8, axes=("sp",)))
