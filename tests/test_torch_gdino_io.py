"""GroundingDINO's weights, preprocessing, tokenizer and ``predict`` in the
port against the JAX package's (and HF transformers' BertTokenizer), on the
CPU, and the golden fixture.

Limits: the state-dict round trip through JAX's converter, the initialiser's
tree of shapes, ``preprocess_image`` against JAX's PIL path, the tokenizer's
ids and ``decode`` against transformers': exact. ``predict``'s boxes and
scores within 1e-5 of their largest magnitude, or 4x JAX's own float32 error
against JAX's float64 ``predict`` where that is larger, that error at most
1e-4 (the random net amplifies rounding); its phrases equal. The golden
fixture's ``gdino_*`` entries at tests/test_golden_fixtures.py's limits
(rtol and atol 1e-4) from JAX's own seeded tree.
"""

import os

import jax
import numpy as np
import pytest
import torch
from transformers import BertTokenizer as HFBertTokenizer

from gs2mesh_tpu.gdino import convert as jconvert
from gs2mesh_tpu.gdino import inference as jinf
from gs2mesh_tpu.gdino import model as jmodel
from gs2mesh_torch.gdino import (GDINO, best_box_xyxy,
                                 convert_gdino_checkpoint, gdino_forward,
                                 init_gdino_params, load_gdino_checkpoint,
                                 load_tokenizer, load_weights,
                                 params_from_numpy, predict,
                                 prepare_text_inputs, released_state_dict)
from gs2mesh_torch.gdino import inference
from tests.test_torch_gdino import (anchored, jax_cfg, perturbed_state,
                                    small_cfg, to_jax, to_x64)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "golden_nets.npz")
VOCAB_SIZE = 30522
WORDS = ["the", "a", "red", "car", "dog", "cat", "main", "object", "_",
         "cafe", "naive", "play", "un", "toy", "it", "is", "isn", "'", "s",
         "t", "n", ",", "!", "-", "中", "国", "σ", "green", "chair", "table",
         "on", "of", "and", "##ing", "##s", "##aff", "##able", "##e", "##n",
         "##t", "##obj", "##ect", "x", "##y", "##z"]


def write_vocab(path):
    """A bert-base-uncased-shaped vocab: [PAD] 0, [UNK] 100, [CLS] 101,
    [SEP] 102, [MASK] 103, '.' 1012, '?' 1029, the test's words and
    pieces from 2000 on, 30,522 lines."""
    vocab = [f"[unused{i}]" for i in range(VOCAB_SIZE)]
    vocab[0], vocab[100], vocab[101], vocab[102], vocab[103] = (
        "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
    vocab[1012], vocab[1029] = ".", "?"
    for i, w in enumerate(WORDS):
        vocab[2000 + 7 * i] = w
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_vocab(tmp_path_factory.mktemp("vocab") / "vocab.txt")


@pytest.fixture(scope="module")
def pair():
    cfg = small_cfg()
    sd = perturbed_state(cfg, seed=1)
    return load_weights(GDINO(cfg), sd).eval(), to_jax(sd, cfg), sd


# ---------------------------------------------------------------- weights

def test_state_dict_round_trip(pair):
    """port state dict -> released layout (module. prefix, a copy of the
    shared head a decoder layer and the decoder's alias, Swin's index
    buffers, a BERT pooler) -> JAX's converter -> params_from_numpy: bit
    for bit."""
    _, _, sd = pair
    released = released_state_dict(sd, small_cfg(), prefix="module.")
    for key in ("module.bbox_embed.1.layers.2.weight",
                "module.transformer.decoder.bbox_embed.1.layers.2.weight",
                "module.bert.pooler.dense.weight",
                "module.backbone.0.layers.3.blocks.0.attn."
                "relative_position_index"):
        assert key in released
    back = params_from_numpy(jax.tree.map(
        np.asarray, jconvert.convert_gdino_state_dict(released)))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_checkpoint_file_loads(tmp_path, pair):
    net, _, sd = pair
    cfg = small_cfg()
    path = str(tmp_path / "groundingdino_small.pth")
    torch.save({"model": released_state_dict(sd, cfg, prefix="module.")},
               path)
    assert not any(k.startswith("module.")
                   for k in convert_gdino_checkpoint(path))
    loaded = load_gdino_checkpoint(path, cfg)
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    # A missing weight, an unknown key and a head copy that differs raise.
    bad = dict(sd)
    bad.pop("feat_map.weight")
    with pytest.raises(RuntimeError, match="feat_map.weight"):
        load_weights(GDINO(cfg), bad)
    with pytest.raises(RuntimeError, match="label_enc"):
        load_weights(GDINO(cfg), {**sd, "label_enc.weight": torch.zeros(1)})
    released = released_state_dict(sd, cfg)
    released["bbox_embed.3.layers.0.bias"] = torch.ones(256)
    with pytest.raises(ValueError, match="bbox_embed.3"):
        load_weights(GDINO(cfg), released)


def _drop_none(tree):
    if isinstance(tree, dict):
        return {k: _drop_none(v) for k, v in tree.items() if v is not None}
    return tree


def test_initialiser_tree_matches_jax():
    """The port's initialiser gives JAX's tree of shapes (through JAX's
    converter; JAX's own initialiser traced with eval_shape)."""
    cfg = small_cfg()
    tree = to_jax(init_gdino_params(cfg, seed=3), cfg)
    want = jax.eval_shape(lambda: jmodel.init_gdino_params(jax_cfg(cfg), 0))
    assert (jax.tree.map(lambda x: x.shape, _drop_none(tree))
            == jax.tree.map(lambda x: x.shape, _drop_none(want)))


def test_golden_fixture():
    """JAX's init_gdino_params(cfg, seed=0) carried across: the golden
    fixture's gdino_logits_sub and gdino_boxes, with the golden test's rng
    stream."""
    cfg = small_cfg()
    net = load_weights(GDINO(cfg), params_from_numpy(jax.tree.map(
        np.asarray, jmodel.init_gdino_params(jax_cfg(cfg), seed=0)))).eval()
    rng = np.random.default_rng(3)
    rng.uniform(0, 255, (1, 3, 64, 96))          # keep rng stream aligned
    rng.uniform(0, 255, (1, 3, 64, 96))          # with the capture script
    img = rng.normal(size=(1, 64, 96, 3)).astype(np.float32)
    ids = np.array([[101, 5, 6, 1012, 7, 102]])
    with torch.no_grad():
        out = gdino_forward(net, torch.from_numpy(img),
                            *prepare_text_inputs(ids, cfg, "cpu"))
    golden = np.load(GOLDEN)
    for got, key in ((out["pred_logits"].numpy()[:, :, :8],
                      "gdino_logits_sub"),
                     (out["pred_boxes"].numpy(), "gdino_boxes")):
        want = golden[key]
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------- preprocessing

@pytest.mark.parametrize("hw, want", [
    ((1162, 1554), (800, 1056)),          # the pipeline's DTU views
    ((96, 120), (800, 992)),              # an upscale
    ((40, 52), (800, 1024)),              # round(32.5) is 32
    ((100, 400), (320, 1344)),            # the 1,333 cap
])
def test_preprocess_image_matches_pil(hw, want):
    rng = np.random.default_rng(sum(hw))
    img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    img[hw[0] // 4: hw[0] // 2, hw[1] // 3: hw[1] // 2] = (220, 60, 30)
    got = inference.preprocess_image(img, "cpu")
    ref = jinf.preprocess_image(img)
    assert got.dtype == torch.float32 and got.shape == (1,) + want + (3,)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("caption", ["main_object", "  A Red Car. ",
                                     "cat.", "Dog . cat", ""])
def test_preprocess_caption(caption):
    assert (inference.preprocess_caption(caption)
            == jinf.preprocess_caption(caption))


# --------------------------------------------------------------- tokenizer

CAPTIONS = [
    "main_object.", "A RED Car.", "Café naïve", "the cat . the dog .",
    "unaffable playing cats?", "xyzzy qwerty toys", "中国 cat",
    "dog's toy, isn't it!", "  tabs\tand\nnewlines ", "[CLS] the [MASK] cat",
    "ΟΔΟΣ", "red-green chair on table", "objects unobject cafes",
    "a" * 101, "",
]


@pytest.mark.parametrize("caption", CAPTIONS)
def test_tokenizer_matches_transformers(vocab, caption):
    ours, ref = load_tokenizer(vocab), HFBertTokenizer(vocab_file=vocab)
    ids = ours(caption)["input_ids"]
    assert ids == ref(caption)["input_ids"]
    assert ours.tokenize(caption) == ref.tokenize(caption)
    assert ours.decode(ids) == ref.decode(ids)
    for sub in (ids[1:-1], ids[::2], ids[1::3]):
        assert ours.decode(sub) == ref.decode(sub)


# ----------------------------------------------------------------- predict

def _wide_image(seed=0):
    """20 x 400: the 1,333 cap gives a 64 x 1344 input (1,785 tokens)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (20, 400, 3)).astype(np.uint8)
    img[4:16, 100:220] = (220, 60, 30)
    return img


@pytest.mark.parametrize("box_threshold", [0.0, 0.35])
def test_predict_matches_jax(pair, vocab, box_threshold, monkeypatch):
    net, jp, _ = pair
    img = _wide_image()
    caption = "the red car . a dog"
    got = predict(net, img, caption, box_threshold=box_threshold,
                  text_threshold=0.25, vocab_path=vocab)
    want = jinf.predict(jp, img, caption, box_threshold=box_threshold,
                        text_threshold=0.25, cfg=jax_cfg(net.cfg),
                        vocab_path=vocab)
    # JAX's predict in float64: the same float32 input image, widened.
    plain = jinf.preprocess_image
    monkeypatch.setattr(jinf, "preprocess_image",
                        lambda *a: plain(*a).astype(np.float64))
    with jax.enable_x64(True):
        exact = jinf.predict(to_x64(jp), img, caption,
                             box_threshold=box_threshold,
                             text_threshold=0.25, cfg=jax_cfg(net.cfg),
                             vocab_path=vocab)
    monkeypatch.undo()
    assert exact[0].dtype == np.float64
    assert len(got[0]) == len(want[0]) == len(exact[0]) > 0
    if box_threshold == 0.0:
        assert len(got[0]) == net.cfg.num_queries
    anchored(got[0], want[0], exact[0])
    anchored(got[1], want[1], exact[1])
    assert got[2] == want[2] == exact[2]
    assert any(got[2])
    # Pre-tokenised ids: the same boxes, no phrases.
    ids = np.asarray(load_tokenizer(vocab)(
        inference.preprocess_caption(caption))["input_ids"])
    pre = predict(net, img, input_ids=ids, box_threshold=box_threshold)
    np.testing.assert_array_equal(pre[0], got[0])
    assert pre[2] == [""] * len(pre[0])


def test_best_box_xyxy():
    rng = np.random.default_rng(5)
    boxes = rng.uniform(0.1, 0.6, (7, 4)).astype(np.float32)
    scores = rng.uniform(size=7).astype(np.float32)
    got = best_box_xyxy(boxes, scores, (32, 400))
    np.testing.assert_array_equal(got, jinf.best_box_xyxy(boxes, scores,
                                                          (32, 400)))
    cx, cy, w, h = boxes[np.argmax(scores)] * np.array([400, 32, 400, 32])
    np.testing.assert_allclose(got, [cx - w / 2, cy - h / 2, cx + w / 2,
                                     cy + h / 2])
    empty = np.zeros((0, 4), np.float32)
    assert best_box_xyxy(empty, np.zeros(0), (32, 400)) is None
    assert jinf.best_box_xyxy(empty, np.zeros(0), (32, 400)) is None
