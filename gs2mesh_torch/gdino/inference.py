"""GroundingDINO inference, the port of gs2mesh_tpu gdino/inference.py
(groundingdino/util/inference.py): image preprocessing (the short side to
800, ImageNet normalisation), text-prompted prediction with box and text
thresholds, and the phrases. Captions go through the port's own BERT
tokenizer (``tokenizer.py``, a ``vocab.txt``); pre-tokenised ids are taken
as they are.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from gs2mesh_torch.core.precision import precision_scope
from gs2mesh_torch.gdino.model import (GDINO, gdino_forward,
                                       prepare_text_inputs)
from gs2mesh_torch.gdino.tokenizer import load_tokenizer
from gs2mesh_torch.sam2.predictor import resize_bilinear_uint8

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_caption(caption: str) -> str:
    result = caption.lower().strip()
    return result if result.endswith(".") else result + "."


def preprocess_image(img: np.ndarray, device="cuda", short_side: int = 800,
                     max_size: int = 1333) -> torch.Tensor:
    """RandomResize([800], max_size=1333) + normalisation of an (H, W, 3)
    uint8 image -> (1, H', W', 3) float32 NHWC on ``device``, H' and W'
    rounded to multiples of 32 (the backbone's stride). The resize is PIL's
    BILINEAR bit for bit (``resize_bilinear_uint8``) and the arithmetic
    numpy's float32, on every device."""
    h, w = img.shape[:2]
    scale = short_side / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh = int(round(h * scale / 32.0)) * 32
    nw = int(round(w * scale / 32.0)) * 32
    x = torch.tensor(img, device=device)
    arr = resize_bilinear_uint8(x, max(nw, 32), max(nh, 32)).to(
        torch.float32)
    # Divisors as device tensors: CUDA turns a host-scalar divisor into a
    # reciprocal product, which rounds apart from numpy's division.
    arr = arr / torch.tensor(255.0, device=arr.device)
    mean = torch.from_numpy(IMAGENET_MEAN).to(arr.device)
    std = torch.from_numpy(IMAGENET_STD).to(arr.device)
    return ((arr - mean) / std)[None]


def predict(model: GDINO, image: np.ndarray, caption: str = None,
            box_threshold: float = 0.35, text_threshold: float = 0.25,
            tokenizer=None, input_ids: Optional[np.ndarray] = None,
            vocab_path: Optional[str] = None
            ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """inference.py:predict on the model's device and dtype (float32 with
    TF32 off, or float64). image: (H, W, 3) uint8.

    Returns (boxes (n, 4) cxcywh normalised, scores (n,), phrases)."""
    if input_ids is None:
        tokenizer = tokenizer or load_tokenizer(vocab_path)
        tokenized = tokenizer(preprocess_caption(caption))
        input_ids = np.asarray(tokenized["input_ids"], np.int64)

    p = next(model.parameters())
    ids, pos_ids, self_masks, pad_mask = prepare_text_inputs(
        input_ids, model.cfg, p.device)
    x = preprocess_image(image, p.device).to(p.dtype)
    with torch.no_grad(), precision_scope():
        out = gdino_forward(model, x, ids, pos_ids, self_masks, pad_mask)
        logits = torch.sigmoid(out["pred_logits"][0])       # (nq, 256)
        scores = logits.amax(dim=1)
    logits = logits.cpu().numpy()
    boxes = out["pred_boxes"][0].cpu().numpy()
    scores = scores.cpu().numpy()

    keep = scores > box_threshold
    sel_boxes = boxes[keep]
    sel_scores = scores[keep]
    sel_logits = logits[keep]

    phrases = []
    if tokenizer is not None:
        for logit in sel_logits:
            posmap = logit[: len(input_ids)] > text_threshold
            token_ids = [int(t) for t, m in zip(input_ids, posmap) if m]
            phrases.append(tokenizer.decode(token_ids).replace(".", ""))
    else:
        phrases = ["" for _ in sel_scores]
    return sel_boxes, sel_scores, phrases


def best_box_xyxy(boxes: np.ndarray, scores: np.ndarray,
                  image_hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """The highest-scoring box as pixel xyxy (the masker's seed contract,
    masker_utils.py:133-162); None with no box."""
    if len(boxes) == 0:
        return None
    h, w = image_hw
    cx, cy, bw, bh = boxes[np.argmax(scores)] * np.array([w, h, w, h])
    return np.array([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2])
