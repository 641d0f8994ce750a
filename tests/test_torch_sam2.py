"""The port's SAM2 (gs2mesh_torch.sam2) against the JAX package's, module by
module and whole, on the CPU.

Weights: the port's seeded tiny model at image size 128 with every leaf then
perturbed (the initialiser alone gives zero biases and identity norms, which
would leave those conversions unexercised) and the object gate opened (the
object-score head's last bias at 5, as tests/test_golden_fixtures.py:95-98
does), carried to JAX by the JAX package's own ``convert_sam2_state_dict``,
which also proves the port's state-dict names are the released ones.
Inputs come from numpy seeds. Tolerances: each module's and each
predictor's output within 1e-5 of its largest magnitude; the resample of
``preprocess_image``, the state-dict round trip and the initialiser's tree
of shapes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2mesh_tpu.sam2 import SAM2Config as JConfig
from gs2mesh_tpu.sam2 import SAM2ImagePredictor as JImagePredictor
from gs2mesh_tpu.sam2 import SAM2VideoPredictor as JVideoPredictor
from gs2mesh_tpu.sam2 import convert as jconvert
from gs2mesh_tpu.sam2 import hiera as jhiera
from gs2mesh_tpu.sam2 import layers as jl
from gs2mesh_tpu.sam2 import memory as jmem
from gs2mesh_tpu.sam2 import model as jmodel
from gs2mesh_tpu.sam2 import predictor as jpred
from gs2mesh_tpu.sam2 import sam_heads as jheads
from gs2mesh_torch.sam2 import (SAM2, SAM2Config, SAM2ImagePredictor,
                                SAM2VideoPredictor, convert_sam2_checkpoint,
                                init_sam2_params, load_sam2_checkpoint,
                                load_weights, params_from_numpy)
from gs2mesh_torch.sam2 import hiera, layers, memory, model, predictor
from gs2mesh_torch.sam2 import sam_heads as heads

torch.set_num_threads(1)

IMG = 128
TOL = 1e-5


def perturbed_state(seed=0):
    """The port's seeded tiny/128 state dict, every leaf moved by normal
    noise of 0.2 of its spread (0.1 where it has none), the gate open."""
    sd = init_sam2_params(SAM2Config.tiny(IMG), seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in sd.values():
            spread = float(t.std()) if t.numel() > 1 else 0.0
            t.add_(torch.from_numpy(rng.normal(
                scale=0.2 * spread if spread > 0 else 0.1,
                size=t.shape).astype(np.float32)))
        sd["sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(5.0)
    return sd


@pytest.fixture(scope="module")
def state():
    return perturbed_state()


@pytest.fixture(scope="module")
def net(state):
    return load_weights(SAM2(SAM2Config.tiny(IMG)), state).eval()


@pytest.fixture(scope="module")
def jparams(state):
    return jconvert.convert_sam2_state_dict(state)


@pytest.fixture(scope="module")
def jcfg():
    return JConfig.tiny(image_size=IMG)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= tol, f"relative gap {err:.3e} > {tol}"


def rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------- layers

def test_state_dict_round_trip(state):
    """port state dict -> JAX's converter -> the port's converter: every
    tensor back bit for bit (including the un-flipped transposed convs)."""
    back = params_from_numpy(jax.tree.map(np.asarray,
                                          jconvert.convert_sam2_state_dict(
                                              state)))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def test_initialiser_tree_matches_jax(jparams):
    """The port's initialiser gives JAX's tree of shapes (JAX's own
    initialiser is drawn from jax.random; the shapes of its output are
    those of the converted tree of a checkpoint of the same config)."""
    tree = jconvert.convert_sam2_state_dict(init_sam2_params(
        SAM2Config.tiny(IMG), seed=1))
    shapes = jax.tree.map(lambda x: x.shape, tree)
    assert shapes == jax.tree.map(lambda x: x.shape, jparams)
    want = jax.eval_shape(lambda: jmodel.init_sam2_params(
        JConfig.tiny(image_size=IMG), seed=0))
    assert shapes == jax.tree.map(lambda x: x.shape, want)


def test_checkpoint_file_loads(tmp_path, state):
    """A released-layout file ({"model": state}, keys under model.) loads
    with its prefix stripped; a missing key raises."""
    path = str(tmp_path / "sam2_hiera_tiny.pt")
    torch.save({"model": {f"model.{k}": v for k, v in state.items()}}, path)
    assert set(convert_sam2_checkpoint(path)) == set(state)
    loaded = load_sam2_checkpoint(path, SAM2Config.tiny(IMG))
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, state[k])
    partial = dict(state)
    partial.pop("no_obj_ptr")
    with pytest.raises(KeyError, match="no_obj_ptr"):
        load_weights(SAM2(SAM2Config.tiny(IMG)), partial)


@pytest.mark.parametrize("window", [4, 5])
def test_window_partition_and_pos_embeds(window):
    rng = np.random.default_rng(window)
    x = rand(rng, 2, 9, 11, 6)
    jw, jpad = jl.window_partition(jnp.asarray(x), window)
    pw, ppad = layers.window_partition(T(x), window)
    assert jpad == ppad
    close(pw, jw, 0.0)
    close(layers.window_unpartition(pw, window, ppad, (9, 11)),
          jl.window_unpartition(jw, window, jpad, (9, 11)), 0.0)
    ref = torch.zeros(1)
    close(layers.sine_pos_embed_2d(9, 11, 64, ref),
          jl.sine_pos_embed_2d(9, 11, 64))
    pos = rand(rng, 7) * 10
    close(layers.get_1d_sine_pe(T(pos), 32),
          jl.get_1d_sine_pe(jnp.asarray(pos), 32))
    g = rand(rng, 2, 16)
    close(layers.random_pe_grid(T(g), 9, 11), jl.random_pe_grid(g, 9, 11))
    np.testing.assert_array_equal(layers.axial_rope_angles(32, 11, 9),
                                  jl.axial_rope_angles(32, 11, 9))
    close(layers.interpolate_nearest_2x(T(x)),
          jl.interpolate_nearest_2x(jnp.asarray(x)), 0.0)


@pytest.mark.parametrize("size", [(40, 64), (7, 9), (32, 32)])
def test_resizes_match_jax(size):
    """resize_linear (antialiased where it shrinks) and resize_nearest
    (half-pixel centres) against jax.image.resize on a (1, 2, 16, 24)
    input: up, down and mixed."""
    rng = np.random.default_rng(size[0])
    x = rand(rng, 1, 2, 16, 24)
    close(layers.resize_linear(T(x), *size),
          jax.image.resize(x, (1, 2) + size, method="linear"))
    close(layers.resize_nearest(T(x), *size),
          jax.image.resize(x, (1, 2) + size, method="nearest"), 0.0)


def test_attention_and_rope_attention(net, jparams):
    rng = np.random.default_rng(1)
    att = net.sam_mask_decoder.transformer.layers[0].cross_attn_token_to_image
    jatt = jparams["sam_mask_decoder"]["transformer"]["layers"]["0"][
        "cross_attn_token_to_image"]
    q, k = rand(rng, 2, 5, 256), rand(rng, 2, 12, 256)
    close(layers.attention(T(q), T(k), T(k), att, 8),
          jl.attention(q, k, k, jatt, 8))
    ca = net.memory_attention.layers[0].cross_attn_image
    jca = jparams["memory_attention"]["layers"]["0"]["cross_attn_image"]
    ang = jl.axial_rope_angles(256, 4, 4)
    q, mem = rand(rng, 1, 16, 256), rand(rng, 1, 2 * 16 + 8, 64)
    close(layers.rope_attention(T(q), T(mem), T(mem), ca, 1,
                                layers.rope_tables(256, 4, 4, T(q)),
                                num_k_exclude_rope=8, rope_k_repeat=True),
          jl.rope_attention(q, mem, mem, jca, 1, jnp.asarray(ang),
                            num_k_exclude_rope=8, rope_k_repeat=True))


# ------------------------------------------------------------------ hiera

def test_hiera_and_neck(net, jparams, jcfg):
    rng = np.random.default_rng(2)
    x = rand(rng, 1, IMG, IMG, 3)
    jtrunk = jparams["image_encoder"]["trunk"]
    jouts = jax.jit(lambda p, i: jhiera.hiera_forward(i, p, jcfg.hiera))(
        jtrunk, jnp.asarray(x))
    with torch.no_grad():
        pouts = hiera.hiera_forward(T(x), net.image_encoder.trunk)
        close(hiera.hiera_pos_embed(net.image_encoder.trunk, 32, 32),
              jhiera.hiera_pos_embed(jtrunk, jcfg.hiera, 32, 32))
        for p_, j_ in zip(pouts, jouts):
            close(p_, j_)
        pf, pp = hiera.fpn_neck_forward(pouts, net.image_encoder.neck)
    jf, jp = jhiera.fpn_neck_forward(jouts, jparams["image_encoder"]["neck"],
                                     256, 4)
    for a, b in zip(pf + pp, jf + jp):
        close(a, b)
    np.testing.assert_array_equal(hiera.bicubic_matrix(7, 32),
                                  jhiera.bicubic_matrix(7, 32))
    for preset in ("tiny", "small", "base_plus", "large"):
        pc, jc = getattr(SAM2Config, preset)(), getattr(JConfig, preset)()
        assert [pc.hiera.block_spec(i) for i in range(pc.hiera.depth)] == \
            [jc.hiera.block_spec(i) for i in range(jc.hiera.depth)]
        assert pc.hiera.channel_list == jc.hiera.channel_list


# ------------------------------------------------------------------ heads

def test_prompt_encoder_and_mask_decoder(net, jparams):
    rng = np.random.default_rng(3)
    pe, jpe = net.sam_prompt_encoder, jparams["sam_prompt_encoder"]
    pts = rng.uniform(0, IMG, (1, 3, 2)).astype(np.float32)
    labs = np.array([[1, 0, -1]], np.int32)
    box = np.array([[10.0, 20.0, 90.0, 100.0]], np.float32)
    mask = rand(rng, 1, 32, 32, 1)
    with torch.no_grad():
        for kw, jkw in (
                (dict(points=(T(pts), T(labs).long())),
                 dict(points=(pts, labs))),
                (dict(points=(T(pts), T(labs).long()), boxes=T(box),
                      masks=T(mask)),
                 dict(points=(pts, labs), boxes=box, masks=mask))):
            ps, pd = heads.prompt_encoder(pe, (8, 8), (IMG, IMG), **kw)
            js, jd = jheads.prompt_encoder(jpe, (8, 8), (IMG, IMG), **jkw)
            close(ps, js)
            close(pd, jd)
        close(heads.get_dense_pe(pe, (8, 8)), jheads.get_dense_pe(jpe, (8, 8)))

        emb = rand(rng, 1, 8, 8, 256)
        hr = [rand(rng, 1, 32, 32, 32), rand(rng, 1, 16, 16, 64)]
        ipe = np.asarray(jheads.get_dense_pe(jpe, (8, 8)))
        js, jd = jheads.prompt_encoder(jpe, (8, 8), (IMG, IMG),
                                       points=(pts, labs))
        for multi in (True, False):
            p_out = heads.mask_decoder(net.sam_mask_decoder, T(emb), T(ipe),
                                       T(np.asarray(js)), T(np.asarray(jd)),
                                       multi, [T(h) for h in hr])
            j_out = jheads.mask_decoder(jparams["sam_mask_decoder"], emb,
                                        ipe, js, jd, multi, hr)
            for a, b in zip(p_out, j_out):
                close(a, b)


# ----------------------------------------------------------------- memory

def test_memory_attention_and_encoder(net, jparams):
    rng = np.random.default_rng(4)
    curr, curr_pos = rand(rng, 1, 64, 256), rand(rng, 1, 64, 256)
    mem, mem_pos = rand(rng, 1, 2 * 64 + 8, 64), rand(rng, 1, 2 * 64 + 8, 64)
    with torch.no_grad():
        close(memory.memory_attention(net.memory_attention, T(curr),
                                      T(curr_pos), T(mem), T(mem_pos), 8,
                                      (8, 8)),
              jmem.memory_attention(jparams["memory_attention"], curr,
                                    curr_pos, mem, mem_pos, 8, (8, 8)))
        pix, probs = rand(rng, 1, 8, 8, 256), rand(rng, 1, IMG, IMG, 1) * 10
        pf, pp = memory.memory_encoder(net.memory_encoder, T(pix), T(probs))
        jf, jp = jmem.memory_encoder(jparams["memory_encoder"], pix, probs)
        close(pf, jf)
        close(pp, jp)


# ------------------------------------------------------------------ model

def test_model_functions(net, jparams, jcfg):
    rng = np.random.default_rng(5)
    img = rand(rng, 1, IMG, IMG, 3)
    jo = jax.jit(lambda p, i: jmodel.forward_image(p, jcfg, i))(
        jparams, jnp.asarray(img))
    with torch.no_grad():
        po = model.forward_image(net, T(img))
        for a, b in zip(po["backbone_fpn"] + po["vision_pos_enc"],
                        jo["backbone_fpn"] + jo["vision_pos_enc"]):
            close(a, b)
        feat = T(np.asarray(jo["backbone_fpn"][2]))
        hr = [T(np.asarray(f)) for f in jo["backbone_fpn"][:2]]
        jhr = jo["backbone_fpn"][:2]
        pts = np.array([[[40.0, 50.0], [90.0, 70.0]]], np.float32)
        labs = np.array([[1, 0]], np.int32)
        small_mask = (rng.random((1, 20, 20, 1)) > 0.5).astype(np.float32)
        for kw in (dict(point_coords=pts, point_labels=labs,
                        multimask_output=True),
                   dict(mask_inputs=small_mask),
                   dict(mask_inputs=rand(rng, 1, 64, 64, 1))):
            p_kw = {k: (T(v).long() if k == "point_labels" else
                        T(v) if isinstance(v, np.ndarray) else v)
                    for k, v in kw.items()}
            p_out = model.forward_sam_heads(net, feat, high_res_features=hr,
                                            **p_kw)
            j_out = jmodel.forward_sam_heads(jparams, jcfg,
                                             jo["backbone_fpn"][2],
                                             high_res_features=jhr, **kw)
            for a, b in zip(p_out, j_out):
                close(a, b)

        m = (rng.random((1, IMG, IMG, 1)) > 0.5).astype(np.float32)
        for a, b in zip(model.use_mask_as_output(net, feat, hr, T(m)),
                        jmodel.use_mask_as_output(jparams, jcfg,
                                                  jo["backbone_fpn"][2], jhr,
                                                  m)):
            close(a, b)
        logits = rand(rng, 1, 1, IMG, IMG) * 5
        pf, pp = model.encode_new_memory(net, feat, T(logits))
        jf, jp = jmodel.encode_new_memory(jparams, jcfg,
                                          jo["backbone_fpn"][2], logits)
        close(pf, jf)
        close(pp, jp)
        mems = rand(rng, 1, 2, 8, 8, 64)
        mpos = rand(rng, 1, 2, 8, 8, 64)
        ptrs = rand(rng, 1, 3, 256)
        close(model.condition_features(net, feat,
                                       T(np.asarray(jo["vision_pos_enc"][2])),
                                       T(mems), T(mpos), T(ptrs)),
              jmodel.condition_features(jparams, jcfg, jo["backbone_fpn"][2],
                                        jo["vision_pos_enc"][2], mems, mpos,
                                        ptrs, None))


# ------------------------------------------------------------- predictors

@pytest.mark.parametrize("shape,size", [((1162, 1554, 3), 1024),
                                        ((96, 120, 3), 128),
                                        ((40, 52, 3), 128),
                                        ((96, 120, 3), 96)])
def test_preprocess_image_bit_equal_to_pil(shape, size):
    """The port's resampler against JAX's PIL BILINEAR path: a down-scale
    from DTU's 1554x1162, 96x120 -> 128, an up-scale and a one-axis
    resize."""
    img = np.random.default_rng(size).integers(0, 256, shape).astype(
        np.uint8)
    np.testing.assert_array_equal(
        predictor.preprocess_image(img, size, "cpu").numpy(),
        jpred.preprocess_image(img, size))
    f = img.astype(np.float32) / 255.0          # the float input branch
    np.testing.assert_array_equal(
        predictor.preprocess_image(f, size, "cpu").numpy(),
        jpred.preprocess_image(f, size))


def _frames(n, seed=0, h=96, w=120):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
    out = []
    for i in range(n):
        f = base.copy()
        f[20 + 3 * i:60 + 3 * i, 30 + 3 * i:70 + 3 * i] = [200, 40, 40]
        out.append(f)
    return out


def test_image_predictor(net, jparams, jcfg):
    img = _frames(1)[0]
    port = SAM2ImagePredictor(net, device="cpu")
    ref = JImagePredictor(jparams, jcfg)
    port.set_image(img)
    ref.set_image(img)
    for kw in (dict(point_coords=np.array([[60.0, 48.0]]),
                    point_labels=np.array([1])),
               dict(box=[30, 20, 70, 60], multimask_output=False)):
        pm, pi, pl = port.predict(**kw)
        jm, ji, jlow = ref.predict(**kw)
        close(pi, ji)
        close(pl, jlow)
        assert pm.shape == jm.shape == (pi.shape[0], 96, 120)
        np.testing.assert_array_equal(pm, jm)


def test_video_propagation(net, jparams, jcfg, tmp_path):
    """3 frames from a PNG directory: the box prompt on frame 0, then
    propagation; then a mask prompt. Logits within 1e-5 of their
    largest magnitude; the memory banks filled alike."""
    from gs2mesh_torch.core.png import write_png

    frames = _frames(3, seed=1)
    for i, f in enumerate(frames):
        write_png(str(tmp_path / f"{i:05}.png"), f)
    port = SAM2VideoPredictor(net, device="cpu")
    ref = JVideoPredictor(jparams, jcfg)
    ps = port.init_state(video_path=str(tmp_path))
    js = ref.init_state(frames=frames)
    a = port.add_new_points_or_box(ps, 0, box=[30, 20, 70, 60])
    b = ref.add_new_points_or_box(js, 0, box=[30, 20, 70, 60])
    assert a[:2] == b[:2]
    close(a[2], b[2])
    seen = []
    for (pf, _, pl), (jf, _, jlog) in zip(port.propagate_in_video(ps),
                                          ref.propagate_in_video(js)):
        assert pf == jf
        close(pl, jlog)
        seen.append(pf)
    assert seen == [0, 1, 2]
    assert sorted(ps["non_cond_outputs"]) == [1, 2]

    mask = np.zeros((96, 120), bool)
    mask[20:60, 30:70] = True
    port.reset_state(ps)
    ref.reset_state(js)
    close(port.add_new_mask(ps, 0, 0, mask)[2],
          ref.add_new_mask(js, 0, 0, mask)[2])
    for (_, _, pl), (_, _, jlog) in zip(
            port.propagate_in_video(ps, max_frame_num_to_track=2),
            ref.propagate_in_video(js, max_frame_num_to_track=2)):
        close(pl, jlog)


def test_init_state_reads_png_only(tmp_path):
    (tmp_path / "000.jpg").write_bytes(b"\xff\xd8")
    port = SAM2VideoPredictor(SAM2(SAM2Config.tiny(IMG)), device="cpu")
    with pytest.raises(ValueError, match="only PNG"):
        port.init_state(video_path=str(tmp_path))


def test_predictors_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        SAM2ImagePredictor(SAM2(SAM2Config.tiny(IMG)))
