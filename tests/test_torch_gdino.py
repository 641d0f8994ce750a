"""The port's GroundingDINO (gs2mesh_torch.gdino) against the JAX package's,
module by module and whole, on the CPU.

Weights: the port's seeded small model (tests/test_gdino.py's config: Swin
embed 32, depths (1, 1, 1, 1); BERT 64 wide, 2 layers; 20 queries; 2 + 2
layers) with every leaf then perturbed (the initialiser alone gives zero
biases, identity norms and 1e-4 layer scales, which would leave those paths
unexercised), carried to JAX in the released layout through the JAX
package's own ``convert_gdino_state_dict``. Inputs come from numpy seeds;
JAX runs eagerly, or jitted as tests/test_gdino.py runs it. Limit: each
output within 1e-5 of its largest finite magnitude, with the -inf positions
equal; the text masks and the top-k indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2mesh_tpu.gdino import bert as jbert
from gs2mesh_tpu.gdino import convert as jconvert
from gs2mesh_tpu.gdino import deform as jdeform
from gs2mesh_tpu.gdino import fusion as jfusion
from gs2mesh_tpu.gdino import model as jmodel
from gs2mesh_tpu.gdino import swin as jswin
from gs2mesh_tpu.gdino import transformer as jtr
from gs2mesh_torch.gdino import (GDINO, GDINOConfig, gdino_decode,
                                 gdino_encode, gdino_forward,
                                 init_gdino_params, load_weights,
                                 prepare_text_inputs, released_state_dict)
from gs2mesh_torch.gdino import bert, deform, fusion, model, swin
from gs2mesh_torch.gdino import transformer as tr
from gs2mesh_torch.gdino.bert import BertConfig
from gs2mesh_torch.gdino.swin import SwinConfig

TOL = 1e-5
SPECIALS = (101, 102, 1012, 1029)


def small_cfg():
    return GDINOConfig(
        swin=SwinConfig(embed_dim=32, depths=(1, 1, 1, 1),
                        num_heads=(1, 2, 4, 8)),
        bert=BertConfig(hidden_size=64, num_layers=2, num_heads=2,
                        intermediate_size=128),
        num_queries=20, num_encoder_layers=2, num_decoder_layers=2)


def jax_cfg(cfg):
    """The JAX package's config of the port's ``cfg``."""
    return jmodel.GDINOConfig(
        swin=jswin.SwinConfig(**vars(cfg.swin)),
        bert=jbert.BertConfig(**vars(cfg.bert)),
        **{k: v for k, v in vars(cfg).items() if k not in ("swin", "bert")})


def perturbed_state(cfg, seed=0):
    """The port's seeded state dict, every leaf moved by normal noise of
    0.2 of its spread (0.1 where it has none)."""
    sd = init_gdino_params(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in sd.values():
            spread = float(t.std()) if t.numel() > 1 else 0.0
            t.add_(torch.from_numpy(rng.normal(
                scale=0.2 * spread if spread > 0 else 0.1,
                size=t.shape).astype(np.float32)))
    return sd


def to_jax(sd, cfg):
    return jconvert.convert_gdino_state_dict(
        released_state_dict(sd, cfg, prefix="module."))


@pytest.fixture(scope="module")
def pair():
    cfg = small_cfg()
    sd = perturbed_state(cfg)
    return load_weights(GDINO(cfg), sd).eval(), to_jax(sd, cfg)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[~fin], want[~fin])
    scale = max(float(np.abs(want[fin]).max()), 1e-30)
    err = float(np.abs(got[fin].astype(np.float64) - want[fin]).max()) / scale
    assert err <= tol, f"relative gap {err:.3e} > {tol}"


def gap(got, want):
    """The largest |got - want| over want's finite entries, relative to
    want's largest finite magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    fin = np.isfinite(want)
    return float(np.abs(got[fin].astype(np.float64) - want[fin]).max()
                 / max(float(np.abs(want[fin]).max()), 1e-30))


JAX_F32_CAP = 1e-4


def to_x64(tree):
    """A JAX parameter tree's floating leaves in float64 (call it under
    ``jax.enable_x64(True)``)."""
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating)
                        else jnp.asarray(a), tree)


def anchored(got, want, exact, tol=TOL):
    """A whole random net amplifies float32 rounding. ``exact`` is JAX's
    own float64 run of what gave JAX's float32 ``want``, so the limit does
    not depend on the port: JAX's float32 error against it must be at most
    1e-4 (JAX_F32_CAP); the port's float32 ``got`` within 1e-5 of ``want``,
    or 4x JAX's own error where that is larger (the rule of
    tests/test_torch_stereo.py::forward_limit); and the port's own error
    against float64 within the same limit."""
    jax_err = gap(want, exact)
    assert jax_err <= JAX_F32_CAP, f"JAX float32 vs float64 {jax_err:.3e}"
    limit = max(tol, 4 * jax_err)
    close(got, want, limit)
    assert gap(got, exact) <= limit


def rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


no_grad = torch.no_grad()


# ------------------------------------------------------------------- swin

@pytest.mark.parametrize("shift", [0, 3])
def test_window_attention(pair, shift):
    net, jp = pair
    rng = np.random.default_rng(1)
    ws, Hp, Wp, C = 7, 14, 21, 64
    x = rand(rng, 2 * (Hp // ws) * (Wp // ws), ws * ws, C)
    mask = swin.shift_attn_mask(Hp, Wp, ws, shift) if shift else None
    np.testing.assert_array_equal(
        mask, None if mask is None else
        np.asarray(jswin._shift_attn_mask(Hp, Wp, ws, shift)))
    m = net.backbone[0].layers[1].blocks[0].attn
    p = jp["backbone"]["layers"]["1"]["blocks"]["0"]["attn"]
    with no_grad:
        got = swin.window_attention(T(x), m, 2, ws,
                                    None if mask is None else T(mask))
    close(got, jswin.window_attention(jnp.asarray(x), p, 2, ws,
                                      None if mask is None
                                      else jnp.asarray(mask)))


@pytest.mark.parametrize("shift", [0, 3])
def test_swin_block_unpadded_sizes(pair, shift):
    """H, W not multiples of the window: the zero pad, the roll and the
    shift mask over the padded grid."""
    net, jp = pair
    rng = np.random.default_rng(2)
    H, W, C = 10, 17, 32
    x = rand(rng, 1, H * W, C)
    m = net.backbone[0].layers[0].blocks[0]
    p = jp["backbone"]["layers"]["0"]["blocks"]["0"]
    with no_grad:
        got = swin.swin_block(T(x), m, H, W, 1, 7, shift)
    close(got, jswin.swin_block(jnp.asarray(x), p, H, W, 1, 7, shift))


def test_patch_merging_odd(pair):
    net, jp = pair
    rng = np.random.default_rng(3)
    H, W, C = 9, 13, 32
    x = rand(rng, 1, H * W, C)
    with no_grad:
        got = swin.patch_merging(T(x), net.backbone[0].layers[0].downsample,
                                 H, W)
    assert got.shape == (1, 5 * 7, 64)
    close(got, jswin.patch_merging(
        jnp.asarray(x), jp["backbone"]["layers"]["0"]["downsample"], H, W))


def test_swin_forward(pair):
    net, jp = pair
    rng = np.random.default_rng(4)
    img = rand(rng, 1, 64, 96, 3)
    with no_grad:
        got = swin.swin_forward(T(img), net.backbone[0])
    want = jax.jit(lambda p, i: jswin.swin_forward(
        i, p, jax_cfg(net.cfg).swin))(jp["backbone"], jnp.asarray(img))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        close(g, w)


# ------------------------------------------------------------------- bert

LAYOUTS = [
    [101, 5, 6, 1012, 7, 102],                  # two phrases
    [101, 5, 6, 7, 8, 102],                     # one phrase
    [101, 102],                                 # no phrase
    [5, 6, 1029, 7, 8, 1012, 9],                # '?', no leading / trailing
    [101, 101, 5, 1012, 1012, 6, 102, 102],     # repeated specials
    [1012, 5, 6, 1029],                         # specials at both ends
]


@pytest.mark.parametrize("ids", LAYOUTS, ids=lambda x: "-".join(map(str, x)))
def test_special_token_masks(ids):
    ids = np.array([ids, ids[::-1]])
    got = bert.generate_masks_with_special_tokens(ids, SPECIALS)
    want = jbert.generate_masks_with_special_tokens(ids, SPECIALS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _text(cfg, ids=(101, 5, 6, 1012, 7, 8, 9, 1029, 102)):
    ids = np.array([ids])
    masks, pos = bert.generate_masks_with_special_tokens(ids, SPECIALS)
    return ids, masks, pos


def test_bert_embeddings_layer_encoder(pair):
    net, jp = pair
    ids, masks, pos = _text(net.cfg)
    m, p = net.bert, jp["bert"]
    with no_grad:
        emb = bert.bert_embeddings(m.embeddings, T(ids), T(pos))
    close(emb, jbert.bert_embeddings(p["embeddings"], jnp.asarray(ids),
                                     jnp.asarray(pos)))
    ext = np.where(masks[:, None], 0.0, bert.MASK_NEG).astype(np.float32)
    x = emb.numpy()
    with no_grad:
        got = bert.bert_layer(T(x), m.encoder.layer[1], 2, T(ext))
    close(got, jbert.bert_layer(jnp.asarray(x), p["encoder"]["layer"]["1"],
                                2, jnp.asarray(ext)))
    with no_grad:
        got = bert.bert_encoder(m, T(ids), T(masks), T(pos))
    close(got, jbert.bert_encoder(p, jnp.asarray(ids), jnp.asarray(masks),
                                  jnp.asarray(pos), jax_cfg(net.cfg).bert))


# ----------------------------------------------------------------- fusion

@pytest.mark.parametrize("mask", ["additive", "key_padding", "none"])
def test_torch_mha(pair, mask):
    net, jp = pair
    rng = np.random.default_rng(5)
    q, k = rand(rng, 2, 7, 256), rand(rng, 2, 5, 256)
    v = rand(rng, 2, 5, 256)
    kw, jkw = {}, {}
    if mask == "additive":
        add = np.where(rng.uniform(size=(2, 7, 5)) < 0.3, -np.inf,
                       rand(rng, 2, 7, 5)).astype(np.float32)
        add[..., 0] = 0.0
        kw["attn_mask"], jkw["attn_mask"] = T(add), jnp.asarray(add)
    elif mask == "key_padding":
        pad = np.array([[False] * 3 + [True] * 2, [False] * 5])
        kw["key_padding_mask"] = T(pad)
        jkw["key_padding_mask"] = jnp.asarray(pad)
    m = net.transformer.decoder.layers[0].ca_text
    p = jp["transformer"]["decoder"]["layers"]["0"]["ca_text"]
    with no_grad:
        got = fusion.torch_mha(T(q), T(k), T(v), m, 8, **kw)
    close(got, jfusion.torch_mha(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), p, 8, **jkw))


def test_text_enhancer_layer(pair):
    net, jp = pair
    rng = np.random.default_rng(6)
    ids, masks, pos = _text(net.cfg)
    x = rand(rng, 1, ids.shape[1], 256)
    pos_text = tr.text_pos_embed(T(pos), T(x))
    close(pos_text, jtr.get_sine_pos_embed(
        jnp.asarray(pos)[..., None].astype(jnp.float32), 256,
        exchange_xy=False))
    with no_grad:
        got = fusion.text_enhancer_layer(
            T(x), net.transformer.encoder.text_layers[1], 4, T(~masks),
            pos_text)
    close(got, jfusion.text_enhancer_layer(
        jnp.asarray(x), jp["transformer"]["encoder"]["text_layers"]["1"], 4,
        jnp.asarray(~masks), jnp.asarray(pos_text.numpy())))


@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_bi_attention(pair, block, padded):
    net, jp = pair
    rng = np.random.default_rng(7)
    v, l = rand(rng, 2, 40, 256), rand(rng, 2, 6, 256)
    mask_l = np.array([[False] * 4 + [True] * 2, [False] * 6]) \
        if padded else None
    m = net.transformer.encoder.fusion_layers[0]
    p = jp["transformer"]["encoder"]["fusion_layers"]["0"]
    fn, jfn = ((fusion.bi_attention_block, jfusion.bi_attention_block)
               if block else (fusion.bi_attention, jfusion.bi_attention))
    if not block:
        m, p = m.attn, p["attn"]
    with no_grad:
        got = fn(T(v), T(l), m, 4,
                 mask_l=None if mask_l is None else T(mask_l))
    want = jfn(jnp.asarray(v), jnp.asarray(l), p, 4,
               mask_l=None if mask_l is None else jnp.asarray(mask_l))
    for g, w in zip(got, want):
        close(g, w)


# ----------------------------------------------------------------- deform

SHAPES = [(6, 9), (3, 5), (2, 3), (1, 2)]


def test_ms_deform_attn_core_border_and_outside():
    """Sampling points outside [0, 1] and exactly on the cell borders
    (integer pixel coordinates), zero padding."""
    rng = np.random.default_rng(8)
    S = sum(h * w for h, w in SHAPES)
    value = rand(rng, 2, S, 3, 4)
    loc = rng.uniform(-0.3, 1.3, size=(2, 11, 3, 4, 4, 2))
    # on borders: loc * size - 0.5 an integer, and at the image edges
    loc[:, :3, :, :, :, 0] = np.array([0.5, 1.5, 2.5])[:, None, None, None] \
        / np.array([w for _, w in SHAPES])[None, None, :, None]
    loc[:, 3, ..., 0] = 0.0
    loc[:, 4, ..., 1] = 1.0
    loc = loc.astype(np.float32)
    w = rng.uniform(size=(2, 11, 3, 4, 4)).astype(np.float32)
    got = deform.ms_deform_attn_core(T(value), SHAPES, T(loc), T(w))
    close(got, jdeform.ms_deform_attn_core(jnp.asarray(value), SHAPES,
                                           jnp.asarray(loc), jnp.asarray(w)))


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_ms_deform_attn(pair, ref_dim):
    net, jp = pair
    rng = np.random.default_rng(9)
    S = sum(h * w for h, w in SHAPES)
    query, value = rand(rng, 1, 13, 256), rand(rng, 1, S, 256)
    ref = rng.uniform(-0.1, 1.1, size=(1, 13, 4, ref_dim)).astype(np.float32)
    if ref_dim == 4:
        ref[..., 2:] = np.abs(ref[..., 2:])
    m = net.transformer.decoder.layers[1].cross_attn
    p = jp["transformer"]["decoder"]["layers"]["1"]["cross_attn"]
    with no_grad:
        got = deform.ms_deform_attn(T(query), T(value), T(ref), SHAPES, m)
    close(got, jdeform.ms_deform_attn(jnp.asarray(query), jnp.asarray(value),
                                      jnp.asarray(ref), SHAPES, p))


# ------------------------------------------------------------ transformer

def test_sine_embeddings():
    rng = np.random.default_rng(10)
    for n in (2, 4):
        pos = rng.uniform(size=(1, 7, n)).astype(np.float32)
        close(tr.gen_sineembed_for_position(T(pos)),
              jtr.gen_sineembed_for_position(jnp.asarray(pos)))
    pos = rng.uniform(size=(3, 5)).astype(np.float32)
    for exchange in (False, True):
        close(tr.get_sine_pos_embed(T(pos), 64, exchange_xy=exchange),
              jtr.get_sine_pos_embed(jnp.asarray(pos), 64,
                                     exchange_xy=exchange))
    for h, w in ((8, 12), (1, 2)):
        close(model.sine_pos_hw(h, w, torch.zeros(()), 128, 20.0),
              jmodel.sine_pos_hw(h, w, 128, 20.0))
    x = rng.uniform(-0.1, 1.1, size=(50,)).astype(np.float32)
    close(tr.inverse_sigmoid(T(x)), jtr.inverse_sigmoid(jnp.asarray(x)))


def test_reference_points_and_proposals():
    """The proposals' invalid rows (a coordinate outside (0.01, 0.99): the
    /8 level's edge cells at 100 rows, every cell of a level whose box side
    0.05 * 2**lvl reaches 0.99) are +inf, their memory rows zero."""
    shapes = [(100, 132), (50, 66), (25, 33), (13, 17), (2, 3)]
    close(tr.get_reference_points(shapes, torch.zeros(())),
          jtr.get_reference_points(shapes))
    S = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(11)
    mem = rand(rng, 1, S, 8)
    got_m, got_p = tr.gen_encoder_output_proposals(T(mem), shapes)
    want_m, want_p = jtr.gen_encoder_output_proposals(jnp.asarray(mem),
                                                      shapes)
    invalid = ~np.isfinite(np.asarray(want_p)).all(-1)
    assert 0 < invalid.sum() < S
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    close(got_p, want_p)


def test_contrastive_embed():
    rng = np.random.default_rng(12)
    x, text = rand(rng, 2, 9, 32), rand(rng, 2, 6, 32)
    pad = np.array([[False] * 4 + [True] * 2, [False] * 6])
    got = tr.contrastive_embed(T(x), T(text), T(pad), 16)
    assert got.shape == (2, 9, 16)
    close(got, jtr.contrastive_embed(jnp.asarray(x), jnp.asarray(text),
                                     jnp.asarray(pad), 16))


def _enc_inputs(rng, n_text=9):
    S = sum(h * w for h, w in SHAPES)
    ids, masks, pos = _text(None)
    return (rand(rng, 1, S, 256), rand(rng, 1, S, 256),
            rand(rng, 1, n_text, 256), np.zeros((1, n_text), bool), masks,
            pos)


def test_encoder_layer_and_encoder(pair):
    net, jp = pair
    src, pos, text, pad, masks, pos_ids = _enc_inputs(
        np.random.default_rng(13))
    ref = tr.get_reference_points(SHAPES, T(src))
    enc, jenc = net.transformer.encoder, jp["transformer"]["encoder"]
    with no_grad:
        got = tr.encoder_layer(T(src), T(pos), ref, SHAPES, enc.layers[0])
    close(got, jtr.encoder_layer(jnp.asarray(src), jnp.asarray(pos),
                                 jtr.get_reference_points(SHAPES), SHAPES,
                                 jenc["layers"]["0"]))
    with no_grad:
        got = tr.encoder_forward(T(src), T(pos), T(text), T(pad), T(masks),
                                 T(pos_ids), SHAPES, enc)
    want = jtr.encoder_forward(jnp.asarray(src), jnp.asarray(pos),
                               jnp.asarray(text), jnp.asarray(pad),
                               jnp.asarray(masks), jnp.asarray(pos_ids),
                               SHAPES, jenc, num_layers=2)
    for g, w in zip(got, want):
        close(g, w)


def test_decoder_layer_and_decoder(pair):
    net, jp = pair
    rng = np.random.default_rng(14)
    memory, _, text, pad, _, _ = _enc_inputs(rng)
    pad[0, -2:] = True
    tgt, qpos = rand(rng, 1, 20, 256), rand(rng, 1, 20, 256)
    ref4 = rng.uniform(0.05, 0.95, size=(1, 20, 4, 4)).astype(np.float32)
    dec, jdec = net.transformer.decoder, jp["transformer"]["decoder"]
    with no_grad:
        got = tr.decoder_layer(T(tgt), T(qpos), T(ref4), T(memory), T(text),
                               T(pad), SHAPES, dec.layers[1])
    close(got, jtr.decoder_layer(
        jnp.asarray(tgt), jnp.asarray(qpos), jnp.asarray(ref4),
        jnp.asarray(memory), jnp.asarray(text), jnp.asarray(pad), SHAPES,
        jdec["layers"]["1"]))
    unsig = rand(rng, 1, 20, 4)
    with no_grad:
        hs, refs = tr.decoder_forward(T(tgt), T(unsig), T(memory), T(text),
                                      T(pad), SHAPES, dec, net.bbox_embed[0])
    jhs, jrefs = jtr.decoder_forward(
        jnp.asarray(tgt), jnp.asarray(unsig), jnp.asarray(memory),
        jnp.asarray(text), jnp.asarray(pad), SHAPES, jdec, jp["bbox_embed"],
        num_layers=2)
    assert len(hs) == len(jhs) == 2 and len(refs) == len(jrefs) == 3
    for g, w in zip(hs + refs, jhs + jrefs):
        close(g, w)


# ------------------------------------------------------------------ whole

def jax_forward(jp, jcfg, img, ids, pos_ids, self_masks, pad_mask,
                topk=None):
    """JAX's gdino_forward (gs2mesh_tpu gdino/model.py:79-152) rebuilt from
    its own functions: also returns the query selection's inputs (the
    encoder ``memory``, each proposal's best logit ``enc_logits``) and its
    picks (``topk``); a given ``topk`` is decoded in place of those
    picks."""
    from gs2mesh_tpu.sam2.layers import conv2d, layer_norm, linear, mlp
    hidden = jbert.bert_encoder(jp["bert"], ids, self_masks, pos_ids,
                                jcfg.bert)
    text = hidden @ jp["feat_map"]["w"] + jp["feat_map"]["b"]
    feats = jswin.swin_forward(img, jp["backbone"], jcfg.swin)
    srcs, poss, shapes = [], [], []
    for lvl, f in enumerate(feats + feats[-1:]):
        last = lvl == len(feats)
        s = conv2d(f, jp["input_proj"][str(lvl)]["0"], stride=2 if last
                   else 1, padding=1 if last else 0)
        s = jmodel.group_norm(s, jp["input_proj"][str(lvl)]["1"])
        srcs.append(s.reshape(1, -1, jcfg.hidden_dim))
        shapes.append(s.shape[1:3])
        poss.append(jmodel.sine_pos_hw(*s.shape[1:3], 128, 20.0).reshape(
            1, -1, jcfg.hidden_dim) + jp["transformer"]["level_embed"][lvl])
    memory, mtext = jtr.encoder_forward(
        jnp.concatenate(srcs, 1), jnp.concatenate(poss, 1), text, pad_mask,
        self_masks, pos_ids, shapes, jp["transformer"]["encoder"],
        jcfg.num_encoder_layers)
    tp = jp["transformer"]
    out_mem, out_props = jtr.gen_encoder_output_proposals(memory, shapes)
    out_mem = layer_norm(linear(out_mem, tp["enc_output"]),
                         tp["enc_output_norm"])
    logits = jtr.contrastive_embed(out_mem, mtext, pad_mask,
                                   jcfg.max_text_len).max(-1)
    picks = jax.lax.top_k(logits, jcfg.num_queries)[1]
    topk = picks if topk is None else topk
    coords = mlp(out_mem, tp["enc_out_bbox_embed"], num_layers=3) + out_props
    refs0 = jnp.take_along_axis(coords, topk[..., None], axis=1)
    tgt = jnp.broadcast_to(tp["tgt_embed"]["weight"][None],
                           (1, jcfg.num_queries, jcfg.hidden_dim))
    hs, refs = jtr.decoder_forward(
        tgt, refs0, memory, mtext, pad_mask, shapes, tp["decoder"],
        jp["bbox_embed"], jcfg.num_decoder_layers)
    boxes = jax.nn.sigmoid(mlp(hs[-1], jp["bbox_embed"], num_layers=3)
                           + jtr.inverse_sigmoid(refs[-2]))
    return {"topk": picks, "memory": memory, "enc_logits": logits,
            "pred_logits": jtr.contrastive_embed(hs[-1], mtext, pad_mask,
                                                 jcfg.max_text_len),
            "pred_boxes": boxes}


def test_gdino_forward(pair):
    net, jp = pair
    jcfg = jax_cfg(net.cfg)
    rng = np.random.default_rng(15)
    img = rand(rng, 1, 64, 96, 3)
    ids = np.array([[101, 2023, 2003, 1012, 2178, 102]], np.int64)
    jin = jmodel.prepare_text_inputs(ids, jcfg)
    pin = prepare_text_inputs(ids, net.cfg, "cpu")
    for g, w in zip(pin, jin):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with no_grad:
        out = gdino_forward(net, T(img), *pin)
    parts = jax.jit(lambda p, i: jax_forward(p, jcfg, i, *jin))(
        jp, jnp.asarray(img))
    np.testing.assert_array_equal(out["topk"].numpy(), parts["topk"])
    close(out["memory"], parts["memory"])
    close(out["enc_logits"], parts["enc_logits"])
    want = jax.jit(lambda p, i: jmodel.gdino_forward(p, jcfg, i, *jin))(
        jp, jnp.asarray(img))
    for key in ("pred_logits", "pred_boxes"):
        close(parts[key], want[key], 1e-6)      # the rebuild is JAX's own
        close(out[key], want[key])
    assert np.isinf(out["pred_logits"].numpy()[..., ids.shape[1]:]).all()
    # The split forward: the encoder and selection, then the decoder on
    # given picks (here JAX's reversed), each against JAX.
    with no_grad:
        enc = gdino_encode(net, T(img), *pin)
        flip = gdino_decode(net, enc, enc["topk"].flip(-1))
    np.testing.assert_array_equal(enc["topk"].numpy(), parts["topk"])
    jflip = jax.jit(lambda p, i, t: jax_forward(p, jcfg, i, *jin, topk=t))(
        jp, jnp.asarray(img), parts["topk"][:, ::-1])
    for key in ("pred_logits", "pred_boxes"):
        close(flip[key], jflip[key])
