"""The port's GroundingDINO at the reference detector's full width (SwinT-OGC,
``GDINOConfig()``: Swin-T, BERT-base, 256 wide, 6 + 6 layers, 900 queries)
against the JAX package's, on the CPU, at a 256 x 320 image: 1,700
proposals, so the top-900 selection is real.

Seeded weights from the port's initialiser, carried to JAX in the released
layout. Limits: the encoder's memory and the query selection's logits
within 1e-5 of their largest magnitude; the two selections equal up to
near-ties (each pick's logit within 1e-5 of the largest |logit| of the
other's pick at that rank: a random net's proposals tie within float32
rounding); then, decoded from JAX's selection, the logits and boxes within
1e-5 of JAX's, or 4x JAX's own float32 error against JAX's float64 forward
on the same picks where that is larger, that error at most 1e-4
(``anchored``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gs2mesh_tpu.gdino import model as jmodel
from gs2mesh_torch.gdino import (GDINO, gdino_decode, gdino_encode,
                                 init_gdino_, prepare_text_inputs)
from tests.test_torch_gdino import (anchored, close, gap, jax_cfg,
                                    jax_forward, to_jax, to_x64)


def test_full_width_swint_ogc():
    net = init_gdino_(GDINO(), torch.Generator().manual_seed(0)).eval()
    assert sum(p.numel() for p in net.parameters()) == 172_249_090
    jcfg = jax_cfg(net.cfg)
    jp = to_jax(net.state_dict(), net.cfg)
    rng = np.random.default_rng(0)
    img = rng.normal(size=(1, 256, 320, 3)).astype(np.float32)
    ids = np.array([[101, 1996, 2417, 2482, 1012, 1037, 3899, 102]])
    jin = jmodel.prepare_text_inputs(ids, jcfg)
    pin = prepare_text_inputs(ids, net.cfg, "cpu")
    x = torch.from_numpy(img)
    with torch.no_grad():
        enc = gdino_encode(net, x, *pin)
    want = jax.jit(lambda p, i: jax_forward(p, jcfg, i, *jin))(
        jp, jnp.asarray(img))
    topk = np.asarray(want["topk"])
    assert enc["memory"].shape == (1, 1700, 256)
    close(enc["memory"], want["memory"])
    close(enc["enc_logits"], want["enc_logits"])
    logits = enc["enc_logits"].numpy()[0]
    picks = enc["topk"].numpy()[0]
    assert len(set(picks)) == 900
    assert gap(logits[picks], logits[topk[0]]) <= 1e-5

    with torch.no_grad():
        got = gdino_decode(net, enc, torch.from_numpy(topk.astype(np.int64)))
    with jax.enable_x64(True):
        exact = jax.jit(lambda p, i, t: jax_forward(p, jcfg, i, *jin,
                                                    topk=t))(
            to_x64(jp), jnp.asarray(img, jnp.float64), jnp.asarray(topk))
        exact = {k: np.asarray(v) for k, v in exact.items()}
    assert exact["pred_boxes"].dtype == np.float64
    for key in ("pred_logits", "pred_boxes"):
        anchored(got[key], want[key], exact[key])
