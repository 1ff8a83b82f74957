"""The port's HF checkpoint loader against the JAX package's and against
HF ``BertModel`` itself.

Each checkpoint is a seeded ``transformers.BertModel`` saved in-process
(``save_pretrained``) beside a ``BertTokenizerFast`` over the WordPiece
vocab asset: nothing is downloaded. ``SentenceEncoder(checkpoint=dir)``
of both packages gives the same embeddings at f32 (atol 1e-5: the two
forwards differ only in summation order), and both match HF's BERT with
mean pooling and L2 normalisation at the bar ``tests/test_hf_parity.py``
holds (cosine >= 0.999: the Flax LayerNorm epsilon is 1e-6, BERT's
1e-12). The port also reads the directory with ``transformers`` made
unimportable, as it must on the GPU machine, bit for bit.
"""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from pathway_tpu.models.encoder import EncoderConfig as JaxConfig  # noqa: E402
from pathway_tpu.models.encoder import SentenceEncoder as JaxEncoder  # noqa: E402
from pathway_tpu.models.encoder import TransformerEncoder as JaxModel  # noqa: E402
from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder  # noqa: E402
from pathway_tpu_torch.models import hf_loader  # noqa: E402
from pathway_tpu_torch.internals.parse_graph import G as PORT_G  # noqa: E402
from pathway_tpu_torch.models.tokenizer import VOCAB_ASSET  # noqa: E402

SENTENCES = [
    "the quick brown fox jumps over the lazy dog",
    "a streaming dataflow framework for real time analytics",
    "tensor processing units multiply matrices in systolic arrays",
    "incremental computation maintains results under insertions and deletions",
    "The Embedding Model maps each sentence to a dense vector.",
    "nearest neighbor search retrieves the most similar documents",
    "checkpointing allows the pipeline to resume after failures!",
    "windows group events by time for aggregation",
]

# the tokenizer corpus: normalisation, punctuation, casing, accents, CJK,
# words past max_input_chars_per_word, and truncation at max_len
TOKEN_CASES = [
    "The quick brown fox jumps over the lazy dog.",
    "hello,world!  multiple   spaces\tand\ttabs",
    "CamelCase UPPERCASE lowercase MiXeD",
    "accented: café naïve résumé Zürich",
    "punctuation!!! ... (parens) [brackets] {braces} a+b=c",
    "unicode: 你好 world — em-dash and 'quotes'",
    "",
    "x" * 150,
    "very long sentence " * 300,
]

GEOMETRIES = {
    "tiny": EncoderConfig.tiny(),
    "bge_small": EncoderConfig.bge_small(),
}


def _save_checkpoint(path, cfg: EncoderConfig, *, seed=0, safe=True, lower=True):
    """A seeded HF BERT checkpoint of ``cfg``'s geometry in ``path``."""
    hf_cfg = transformers.BertConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden,
        num_hidden_layers=cfg.layers, num_attention_heads=cfg.heads,
        intermediate_size=cfg.mlp, max_position_embeddings=cfg.max_len,
    )
    torch.manual_seed(seed)
    model = transformers.BertModel(hf_cfg).eval()
    os.makedirs(path, exist_ok=True)
    model.save_pretrained(str(path), safe_serialization=safe)
    # the asset's first vocab_size entries: every id fits the table
    with open(VOCAB_ASSET, encoding="utf-8") as f:
        vocab = f.read().splitlines()[: cfg.vocab_size]
    vocab_file = os.path.join(str(path), "vocab.txt")
    with open(vocab_file, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    transformers.BertTokenizerFast(
        vocab_file=vocab_file, do_lower_case=lower,
    ).save_pretrained(str(path))
    return model


def _hf_embed(model, ids, mask):
    """HF BertModel + mean pool + L2 normalise (bge pooling)."""
    with torch.no_grad():
        out = model(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask).long()).last_hidden_state
        m = torch.from_numpy(mask).unsqueeze(-1).float()
        pooled = (out * m).sum(1) / m.sum(1).clamp(min=1.0)
        return torch.nn.functional.normalize(pooled, dim=-1).numpy()


def _port_f32(enc):
    enc.config = dataclasses.replace(enc.config, dtype=torch.float32)
    enc.model.config = enc.config
    return enc


def _jax_f32(enc):
    # the jitted forwards read ``enc.model`` when they first trace
    enc.config = dataclasses.replace(enc.config, dtype=jnp.float32)
    enc.model = JaxModel(enc.config)
    return enc


@pytest.fixture(autouse=True)
def _clear_port_graph():
    PORT_G.clear()
    yield
    PORT_G.clear()


@pytest.fixture
def no_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert hf_loader._transformers() is None


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_checkpoint_encoder_matches_the_jax_package_and_hf(tmp_path, geometry):
    cfg = GEOMETRIES[geometry]
    model = _save_checkpoint(tmp_path, cfg)
    port = _port_f32(SentenceEncoder(checkpoint=str(tmp_path), device="cpu"))
    ref = _jax_f32(JaxEncoder(checkpoint=str(tmp_path)))
    assert port.config == dataclasses.replace(cfg, dtype=torch.float32)
    got = port.encode(SENTENCES)
    want = np.asarray(ref.encode(SENTENCES))
    np.testing.assert_allclose(got, want, atol=1e-5)
    ids, mask = port.tokenizer(SENTENCES)
    hf = _hf_embed(model, ids, mask)
    for emb in (got, want):
        cos = np.sum(emb * hf, axis=-1)
        assert np.all(cos >= 0.999), f"min cosine {cos.min()}"
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_checkpoint_encoder_bf16_matches_the_jax_package(tmp_path):
    _save_checkpoint(tmp_path, GEOMETRIES["tiny"], seed=3)
    got = SentenceEncoder(checkpoint=str(tmp_path), device="cpu").encode(SENTENCES)
    want = np.asarray(JaxEncoder(checkpoint=str(tmp_path)).encode(SENTENCES))
    cos = np.sum(got * want, axis=-1)
    assert np.all(cos >= 0.999), f"min cosine {cos.min()}"


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_loader_without_transformers_reads_the_same_checkpoint(
    tmp_path, monkeypatch, safe
):
    model = _save_checkpoint(tmp_path, GEOMETRIES["tiny"], seed=1, safe=safe)
    assert os.path.exists(tmp_path / ("model.safetensors" if safe else "pytorch_model.bin"))
    cfg1, sd1, tok1 = hf_loader.load_bert_encoder(str(tmp_path))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "transformers", None)
        cfg2, sd2, tok2 = hf_loader.load_bert_encoder(str(tmp_path))
    assert type(tok1).__name__ == "_HFTokenizerAdapter"
    assert type(tok2).__name__ == "WordPieceTokenizer"
    assert cfg1 == cfg2 == EncoderConfig.tiny()
    assert sd1.keys() == sd2.keys() == SentenceEncoder(
        EncoderConfig.tiny(), device="cpu").model.state_dict().keys()
    for name in sd1:
        assert sd1[name].dtype == torch.float32
        assert torch.equal(sd1[name], sd2[name]), name
    # torch Linear weights go in as they are: no transpose
    hf_sd = model.state_dict()
    assert torch.equal(sd1["blocks.1.mlp_in.weight"],
                       hf_sd["encoder.layer.1.intermediate.dense.weight"])
    assert torch.equal(sd1["blocks.0.attention.out.weight"],
                       hf_sd["encoder.layer.0.attention.output.dense.weight"])
    for text in TOKEN_CASES:
        a, b = tok1([text]), tok2([text])
        assert a[0].tolist() == b[0].tolist(), text
        assert a[1].tolist() == b[1].tolist(), text
    a, b = tok1(TOKEN_CASES), tok2(TOKEN_CASES)
    assert a[0].tolist() == b[0].tolist() and a[1].tolist() == b[1].tolist()
    assert a[0].shape[1] == EncoderConfig.tiny().max_len  # truncated


@pytest.mark.parametrize("lower", [True, False], ids=["uncased", "cased"])
def test_wordpiece_fallback_gives_the_fast_tokenizers_ids(tmp_path, monkeypatch, lower):
    """bge-small geometry (the whole vocab asset, max_len 512): [CLS]/[SEP],
    truncation at 512 and ``do_lower_case`` from tokenizer_config.json."""
    _save_checkpoint(tmp_path, GEOMETRIES["bge_small"], lower=lower)
    with open(tmp_path / "tokenizer_config.json", encoding="utf-8") as f:
        assert json.load(f)["do_lower_case"] is lower
    _, _, fast = hf_loader.load_bert_encoder(str(tmp_path))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "transformers", None)
        _, _, ours = hf_loader.load_bert_encoder(str(tmp_path))
    assert ours.lowercase is lower
    for text in TOKEN_CASES:
        a, b = fast([text]), ours([text])
        assert a[0].tolist() == b[0].tolist(), text
    ids, _ = ours(TOKEN_CASES)
    assert ids.shape[1] == 512
    assert ids[0, 0] == ours.cls_id and ids[-1, -1] == ours.sep_id


def test_encoder_without_transformers_loads_the_same_weights(tmp_path, no_transformers):
    _save_checkpoint(tmp_path, GEOMETRIES["tiny"], seed=2)
    enc = SentenceEncoder(checkpoint=str(tmp_path), device="cpu")
    assert type(enc.tokenizer).__name__ == "WordPieceTokenizer"
    _, sd, _ = hf_loader.load_bert_encoder(str(tmp_path))
    for name, t in enc.model.state_dict().items():
        assert torch.equal(t, sd[name]), name
    seeded = SentenceEncoder(EncoderConfig.tiny(), device="cpu")
    assert not torch.equal(enc.model.tok_embed.weight, seeded.model.tok_embed.weight)


def test_safetensors_reader_equals_the_library(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 2, 2, generator=g).bfloat16(),
        "i64": torch.arange(11, dtype=torch.int64),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "t.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    got = hf_loader.read_safetensors(path)
    want = safetensors_torch.load_file(path)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        assert torch.equal(got[name], want[name]), name
    with open(path, "r+b") as f:  # a header that overruns the file
        f.write((1 << 40).to_bytes(8, "little"))
    with pytest.raises(ValueError, match="overruns"):
        hf_loader.read_safetensors(path)


def test_bert_prefix_and_old_layernorm_names_are_read(tmp_path):
    model = _save_checkpoint(tmp_path / "plain", GEOMETRIES["tiny"], seed=4)
    pre = tmp_path / "prefixed"
    os.makedirs(pre)
    for f in ("config.json", "vocab.txt", "tokenizer_config.json"):
        with open(tmp_path / "plain" / f, "rb") as src, open(pre / f, "wb") as dst:
            dst.write(src.read())
    # the older layout: a "bert." prefix and LayerNorm gamma/beta
    sd = {f"bert.{k}".replace("LayerNorm.weight", "LayerNorm.gamma")
          .replace("LayerNorm.bias", "LayerNorm.beta"): v
          for k, v in model.state_dict().items()}
    assert "bert.embeddings.LayerNorm.gamma" in sd
    sd["cls.predictions.bias"] = torch.zeros(3)  # a head the encoder drops
    torch.save(sd, pre / "pytorch_model.bin")
    _, want, _ = hf_loader.load_bert_encoder(str(tmp_path / "plain"))
    _, got, _ = hf_loader.load_bert_encoder(str(pre))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_missing_checkpoint_keeps_the_seeded_weights(tmp_path):
    seeded = SentenceEncoder(EncoderConfig.tiny(), device="cpu", seed=5)
    empty = tmp_path / "no_weights"
    os.makedirs(empty)
    with open(empty / "config.json", "w") as f:
        json.dump({}, f)
    for missing in (str(tmp_path / "absent"), str(empty)):
        enc = SentenceEncoder(EncoderConfig.tiny(), checkpoint=missing,
                              device="cpu", seed=5)
        assert enc.config == EncoderConfig.tiny()
        for name, t in seeded.model.state_dict().items():
            assert torch.equal(enc.model.state_dict()[name], t), name
    # the JAX package falls back the same way
    ref = JaxEncoder(JaxConfig.tiny(), checkpoint=str(tmp_path / "absent"))
    assert ref.config.hidden == EncoderConfig.tiny().hidden


def test_hub_name_without_transformers_keeps_the_seeded_weights(no_transformers):
    with pytest.raises(OSError, match="transformers"):
        hf_loader.load_bert_encoder("BAAI/bge-small-en-v1.5")
    enc = SentenceEncoder(EncoderConfig.tiny(), checkpoint="BAAI/bge-small-en-v1.5",
                          device="cpu")
    assert enc.config == EncoderConfig.tiny()


def test_checkpoint_of_the_wrong_geometry_raises(tmp_path):
    _save_checkpoint(tmp_path, GEOMETRIES["tiny"])
    with open(tmp_path / "config.json", encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["hidden_size"] = 128  # the tensors are 64 wide
    with open(tmp_path / "config.json", "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="shape"):
        SentenceEncoder(checkpoint=str(tmp_path), device="cpu")
    with pytest.raises(Exception) as exc:  # the JAX package surfaces it too
        JaxEncoder(checkpoint=str(tmp_path))
    assert not isinstance(exc.value, OSError)


def test_embedder_serves_the_checkpoint_weights(tmp_path):
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    _save_checkpoint(tmp_path, GEOMETRIES["tiny"], seed=6)
    enc = SentenceEncoder(checkpoint=str(tmp_path), device="cpu")
    emb = SentenceTransformerEmbedder(encoder=enc)
    assert emb.get_embedding_dimension() == EncoderConfig.tiny().hidden
    t = pw.debug.table_from_markdown("text\nhello world\ncheckpoint weights")
    rows = pw.debug.table_to_pandas(t.select(v=emb(pw.this.text)))
    got = np.stack(rows["v"].to_list())
    want = enc.encode(["hello world", "checkpoint weights"])
    assert sorted(map(tuple, got.round(6))) == sorted(map(tuple, want.round(6)))
