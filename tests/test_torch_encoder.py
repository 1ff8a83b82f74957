"""The PyTorch sentence encoder and tokenizers against the JAX package.

The same seeded inputs and the same weights (the Flax tree carried across
with ``flax_params_to_torch``) go through both packages on the CPU.
Tolerances: at f32 the two forwards differ only in summation order, so
embeddings agree to atol 1e-5; at bf16 the two frameworks round at other
places, so the bar is a per-row cosine of 0.999 (the one
tests/test_hf_parity.py holds the Flax encoder to).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.internals import device as jdevice
from pathway_tpu.models import encoder as jenc
from pathway_tpu.models import tokenizer as jtok
from pathway_tpu_torch.internals import device as tdevice
from pathway_tpu_torch.models import convert, encoder as tenc, tokenizer as ttok

TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "pack my box with five dozen liquor jugs",
    "",
    "Extraordinarily long-winded, hyphenated words: ünïcödé, naïve café!",
    "a " * 40,
    "sphinx of black quartz judge my vow " * 5,
]


def _pair(cfg_kw, jdt, tdt, seed=0, batch_size=16):
    jcfg = dataclasses.replace(jenc.EncoderConfig(**cfg_kw), dtype=jdt)
    tcfg = dataclasses.replace(tenc.EncoderConfig(**cfg_kw), dtype=tdt)
    je = jenc.SentenceEncoder(jcfg, seed=seed, batch_size=batch_size)
    params = jax.tree_util.tree_map(np.asarray, je.params)
    te = tenc.SentenceEncoder(
        tcfg, params=convert.flax_params_to_torch(params, tcfg),
        batch_size=batch_size, device="cpu",
    )
    return je, te


TINY = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp=128, max_len=64)
# full bge-small width (hidden 384, 12 heads of 32, MLP 1536, the WordPiece
# vocab) at one layer, to keep the CPU run short
WIDE = dict(vocab_size=30522, hidden=384, layers=1, heads=12, mlp=1536, max_len=512)


@pytest.mark.parametrize("cfg_kw", [TINY, WIDE], ids=["tiny", "bge_small_1layer"])
@pytest.mark.parametrize("seed", [0, 7])
def test_encoder_f32_matches_flax(cfg_kw, seed):
    je, te = _pair(cfg_kw, jnp.float32, torch.float32, seed=seed)
    want = np.asarray(je.encode(TEXTS))
    got = te.encode(TEXTS)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("cfg_kw", [TINY, WIDE], ids=["tiny", "bge_small_1layer"])
def test_encoder_bf16_cosine(cfg_kw):
    je, te = _pair(cfg_kw, jnp.bfloat16, torch.bfloat16, seed=3)
    want = np.asarray(je.encode(TEXTS))
    got = te.encode(TEXTS)
    cos = (got * want).sum(-1) / (
        np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1)
    )
    assert cos.min() >= 0.999, cos


@pytest.mark.parametrize(
    "n,L,cap", [(1, 3, 16), (5, 17, 16), (9, 40, 256), (3, 100, 64), (16, 33, 16)]
)
def test_pad_batch_matches(n, L, cap):
    rng = np.random.default_rng(n * 100 + L)
    ids = rng.integers(0, 500, size=(n, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, size=n)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    want = jenc.pad_batch(ids, mask, 64, cap)
    got = tenc.pad_batch(ids, mask, 64, cap)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]


def test_compact_path_matches_full_ids_and_mask():
    _, te = _pair(TINY, jnp.float32, torch.float32)
    ids, mask = te.tokenizer(TEXTS)
    ids_p, mask_p, n = tenc.pad_batch(ids, mask, 64, te.batch_size)
    compact = tenc.compact_tokens(ids_p, mask_p, te.config.vocab_size)
    assert compact is not None
    ids_c, mask_c = tenc.expand_compact(*(torch.from_numpy(a) for a in compact))
    np.testing.assert_array_equal(ids_c.numpy(), ids_p)
    np.testing.assert_array_equal(mask_c.numpy(), mask_p)
    full = te.forward(torch.from_numpy(ids_p).long(), torch.from_numpy(mask_p))[:n]
    np.testing.assert_array_equal(te.encode_tokens_device(ids, mask).numpy(), full.numpy())
    # ids past 2^15 survive the 16-bit wire (they travel as int16 bits)
    big = np.array([[1, 40000, 65535, 0]], np.int32)
    m = np.array([[1, 1, 1, 0]], np.int32)
    c = tenc.compact_tokens(big, m, 65536)
    back, _ = tenc.expand_compact(*(torch.from_numpy(a) for a in c))
    np.testing.assert_array_equal(back.numpy(), big)
    # a mask with a hole is not a prefix: no compact form
    assert tenc.compact_tokens(big, np.array([[1, 0, 1, 0]], np.int32), 512) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_padding_row_pools_to_zeros(dtype):
    cfg = dataclasses.replace(tenc.EncoderConfig.tiny(), dtype=dtype)
    te = tenc.SentenceEncoder(cfg, device="cpu", seed=1)
    ids, mask = te.tokenizer(TEXTS[:3])
    ids_p, mask_p, n = tenc.pad_batch(ids, mask, 64, 16)
    assert ids_p.shape[0] > n  # pad_batch added all-padding rows
    out = te.forward(torch.from_numpy(ids_p).long(), torch.from_numpy(mask_p))
    assert torch.isfinite(out).all()
    assert torch.equal(out[n:], torch.zeros_like(out[n:]))
    np.testing.assert_allclose(out[:n].norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_wordpiece_ids_identical_at_512():
    jt = jtok.get_tokenizer(vocab_size=30522, max_length=512)
    tt = ttok.get_tokenizer(vocab_size=30522, max_length=512)
    assert type(tt).__name__ == type(jt).__name__ == "WordPieceTokenizer"
    rng = np.random.default_rng(5)
    words = list(tt.vocab)[1000:6000]
    long_text = " ".join(rng.choice(words, 700))  # past 512 tokens: truncated
    texts = TEXTS + [
        long_text,
        "北京欢迎你 and CJK 漢字 mixed",
        "tabs\tand\nnewlines\r\ncontrol\x00chars",
        "x" * 150 + " supercalifragilisticexpialidocious",
    ]
    for got, want in zip(tt(texts), jt(texts)):
        np.testing.assert_array_equal(got, want)
    assert tt(texts)[0].shape[1] == 512


def test_tiny_geometry_falls_back_to_hash_tokenizer():
    jt = jtok.get_tokenizer(vocab_size=512, max_length=64)
    tt = ttok.get_tokenizer(vocab_size=512, max_length=64)
    assert isinstance(tt, ttok.HashTokenizer) and isinstance(jt, jtok.HashTokenizer)
    for got, want in zip(tt(TEXTS), jt(TEXTS)):
        np.testing.assert_array_equal(got, want)
    forced = ttok.get_tokenizer(prefer="hash")
    assert isinstance(forced, ttok.HashTokenizer)


def test_random_params_have_the_flax_tree_shapes():
    cfg = tenc.EncoderConfig.tiny()
    je = jenc.SentenceEncoder(jenc.EncoderConfig.tiny())
    want = jax.tree_util.tree_map(lambda a: a.shape, je.params)
    got = jax.tree_util.tree_map(
        lambda a: a.shape, convert.random_flax_params(cfg, seed=0)
    )
    assert got == want
    sd = convert.init_params(cfg, seed=0)
    model = tenc.TransformerEncoder(cfg)
    model.load_state_dict(sd)  # strict: every key present, no extras
    again = convert.init_params(cfg, seed=0)
    assert all(torch.equal(sd[k], again[k]) for k in sd)


@pytest.mark.parametrize("L", [8, 64, 512])
@pytest.mark.parametrize("preset", ["bge_small", "bge_base", "tiny"])
def test_cost_models_match(preset, L):
    jc = getattr(jenc.EncoderConfig, preset)()
    tc = getattr(tenc.EncoderConfig, preset)()
    assert tenc.forward_cost_model(tc, 32, L) == jenc.forward_cost_model(jc, 32, L)
    assert tenc.encoder_param_bytes(tc) == jenc.encoder_param_bytes(jc)
    assert dataclasses.replace(tc, dtype=None) == tenc.EncoderConfig(
        **{f.name: getattr(jc, f.name) for f in dataclasses.fields(jc) if f.name != "dtype"},
        dtype=None,
    )


def test_shape_buckets_match():
    for n in range(0, 600, 7):
        for cap in (16, 256, 1024):
            assert tdevice.batch_bucket(n, 8, cap) == jdevice.batch_bucket(n, 8, cap)
            assert tdevice.seq_bucket(n, cap) == jdevice.seq_bucket(n, cap)
        assert tdevice.pow2_capacity(n) == jdevice.pow2_capacity(n)
        assert tdevice.query_pad(n) == jdevice.query_pad(n)
        for chunk in (None, 64):
            assert tdevice.knn_search_bucket(n + 1, 4096, 10, chunk) == (
                jdevice.knn_search_bucket(n + 1, 4096, 10, chunk)
            )
        assert tdevice.encoder_bucket(n, 32, True) == jdevice.encoder_bucket(n, 32, True)
        assert tdevice.ingest_bucket(n, 32, 128, "uint16") == (
            jdevice.ingest_bucket(n, 32, 128, "uint16")
        )
