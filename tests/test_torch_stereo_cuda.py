"""The port's DLNR on the card against itself on the CPU. Marked ``cuda``;
each test skips without a CUDA device. Imports neither JAX nor PIL, cv2 or
matplotlib, so on a machine with a card and none of them it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_stereo_cuda.py

Float64 on both devices must agree to 1e-8 of the largest |disparity| (the
same function); float32 (TF32 off) within 1e-4 of it, or within 4x the CPU's
own float32 error against float64 where that is larger (this random-weight
net amplifies rounding several hundredfold in two iterations); the bf16
policy within 0.15 of float32, the JAX test's limit
(tests/test_stereo_dlnr.py:77-105).
"""

import copy

import pytest
import torch

from chip_smoke import stereo_pair
from gs2mesh_torch.stereo import DLNR, DLNRConfig, dlnr_forward, init_dlnr_
from gs2mesh_torch.stereo.layers import matmul_dtype

pytestmark = pytest.mark.cuda
H, W = 128, 192


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the same "
                    "card-vs-CPU checks on the card")


@pytest.fixture(scope="module")
def models():
    need_cuda()
    m = init_dlnr_(DLNR(), torch.Generator().manual_seed(0)).eval()
    return {("cpu", torch.float32): m,
            ("cpu", torch.float64): copy.deepcopy(m).double(),
            ("cuda", torch.float32): copy.deepcopy(m).cuda(),
            ("cuda", torch.float64): copy.deepcopy(m).double().cuda()}


def run(models, dev, dtype, flow_init=None, policy=None):
    a, b = stereo_pair(H, W)
    cast = lambda x: None if x is None else x.to(dev, dtype)  # noqa: E731
    m = models[(dev, dtype)]
    with torch.inference_mode(), matmul_dtype(policy):
        _, disp = dlnr_forward(m, cast(a), cast(b), DLNRConfig(iters=2),
                               cast(flow_init))
    return disp.double().cpu(), m.last_refined


@pytest.mark.parametrize("init", [None, -40.0, 40.0])
def test_dlnr_card_matches_cpu(models, init):
    flow_init = None if init is None else torch.full(
        (2, 2, H // 4, W // 4), init)
    exact, refined = run(models, "cpu", torch.float64, flow_init)
    card64, refined64 = run(models, "cuda", torch.float64, flow_init)
    cpu32, _ = run(models, "cpu", torch.float32, flow_init)
    card32, refined32 = run(models, "cuda", torch.float32, flow_init)
    assert refined is refined64 is refined32 is (init == -40.0)
    scale = float(exact.abs().max())
    assert float((card64 - exact).abs().max()) <= 1e-8 * scale
    limit = max(1e-4, 4 * float((cpu32 - exact).abs().max()) / scale)
    assert float((card32 - cpu32).abs().max()) <= limit * scale
    assert float((card32 - exact).abs().max()) <= limit * scale


def test_dlnr_bf16_policy_on_card(models):
    d32, _ = run(models, "cuda", torch.float32)
    d16, _ = run(models, "cuda", torch.float32, policy=torch.bfloat16)
    assert bool(torch.isfinite(d16).all())
    assert float((d32 - d16).abs().max()) / float(d32.abs().max()) < 0.15
