"""The port's SAM2 against the frozen SAM2 outputs of
tests/fixtures/golden_nets.npz, with the weights and inputs
tests/test_golden_fixtures.py::test_sam2_golden replays: the JAX package's
seeded tiny/128 tree (init_sam2_params(seed=0), the object gate opened)
carried to the port by ``params_from_numpy``. Limits: the golden test's own
(rtol and atol 1e-4 on the image features, 1e-3 on the IoUs, the low-res
logits and the video logits)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gs2mesh_tpu.sam2 import SAM2Config as JConfig
from gs2mesh_tpu.sam2 import init_sam2_params as j_init_sam2_params
from gs2mesh_torch.sam2 import (SAM2, SAM2Config, SAM2ImagePredictor,
                                SAM2VideoPredictor, load_weights,
                                params_from_numpy)
from gs2mesh_torch.sam2.model import NO_OBJ_SCORE, forward_image

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_nets.npz")


def _close(got, want, rtol=1e-4, atol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol)


def test_sam2_golden():
    golden = np.load(FIX)
    params = j_init_sam2_params(JConfig.tiny(image_size=128), seed=0)
    params["sam_mask_decoder"]["pred_obj_score_head"]["layers"]["2"]["b"] \
        = jnp.full((1,), 5.0, jnp.float32)
    net = load_weights(SAM2(SAM2Config.tiny(128)),
                       params_from_numpy(jax.tree.map(np.asarray, params)))
    del params

    # The golden generator's rng stream (tests/test_golden_fixtures.py).
    rng = np.random.default_rng(3)
    rng.uniform(0, 255, (1, 3, 64, 96))
    rng.uniform(0, 255, (1, 3, 64, 96))
    rng.normal(size=(1, 64, 96, 3))
    img128 = rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    with torch.no_grad():
        out = forward_image(net, torch.from_numpy(img128))
    # jax.tree.leaves order of the dict: backbone_fpn[0] first,
    # vision_pos_enc[2] last.
    _close(out["backbone_fpn"][0].numpy().reshape(-1)[::97][:256],
           golden["sam2_feat0_sub"])
    _close(out["vision_pos_enc"][2].numpy().reshape(-1)[::97][:256],
           golden["sam2_feat_last_sub"])

    pred = SAM2ImagePredictor(net, device="cpu")
    image = rng.uniform(0, 255, (96, 120, 3)).astype(np.uint8)
    pred.set_image(image)
    _, ious, low = pred.predict(point_coords=np.array([[60.0, 48.0]]),
                                point_labels=np.array([1]))
    _close(ious, golden["sam2_ious"], rtol=1e-3, atol=1e-3)
    low_sub = low.reshape(-1)[::31][:512]
    assert np.all(low_sub > NO_OBJ_SCORE / 2)
    assert np.std(low_sub) > 1e-3
    _close(low_sub, golden["sam2_low_masks_sub"], rtol=1e-3, atol=1e-3)

    vid = SAM2VideoPredictor(net, device="cpu")
    frames = [np.asarray(rng.uniform(0, 255, (96, 120, 3)), np.uint8)
              for _ in range(2)]
    state = vid.init_state(frames=frames)
    vid.add_new_points_or_box(state, frame_idx=0, box=[30, 20, 70, 60])
    prop = {f: logits for f, _, logits in vid.propagate_in_video(state)}
    f1_sub = prop[1].reshape(-1)[::23][:512]
    assert np.std(f1_sub) > 1e-3
    _close(f1_sub, golden["sam2_video_f1_sub"], rtol=1e-3, atol=1e-3)
