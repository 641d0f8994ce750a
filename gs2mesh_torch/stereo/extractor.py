"""Channel-attention transformer extractor (a Restormer-style U-Net).

The port's copy of gs2mesh_tpu stereo/extractor.py (DLNR's
Channel_Attention_Transformer_Extractor, core/extractor.py:229-341):
PixelUnshuffle(4) embed, 4 encoder levels (dims 64/128/256/512, blocks
[4,6,6,8], heads [1,2,4,8]), a PixelShuffle decoder with skip concats, and
the context heads at 1/4, 1/8 and 1/16 resolution beside the shared volume
feature.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gs2mesh_torch.stereo.layers import (Resample, conv2d, downsample,
                                         run_stack, transformer_stack,
                                         upsample)

DIM = 64
NUM_BLOCKS = (4, 6, 6, 8)
HEADS = (1, 2, 4, 8)


class Extractor(nn.Module):
    def __init__(self):
        super().__init__()
        d = DIM
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(48, d, 3, padding=1, bias=False)
        self.encoder_level1 = transformer_stack(NUM_BLOCKS[0], d, HEADS[0])
        self.down1_2 = Resample(d, d // 2)
        self.encoder_level2 = transformer_stack(NUM_BLOCKS[1], 2 * d, HEADS[1])
        self.down2_3 = Resample(2 * d, d)
        self.encoder_level3 = transformer_stack(NUM_BLOCKS[2], 4 * d, HEADS[2])
        self.down3_4 = Resample(4 * d, 2 * d)
        self.latent = transformer_stack(NUM_BLOCKS[3], 8 * d, HEADS[3])
        self.up4_3 = Resample(8 * d, 16 * d)
        self.reduce_chan_level3 = nn.Conv2d(8 * d, 4 * d, 1, bias=False)
        self.decoder_level3 = transformer_stack(NUM_BLOCKS[2], 4 * d, HEADS[2])
        self.up3_2 = Resample(4 * d, 8 * d)
        self.reduce_chan_level2 = nn.Conv2d(4 * d, 2 * d, 1, bias=False)
        self.reduce_chan_level2_copy = nn.Conv2d(4 * d, 2 * d, 1, bias=False)
        self.decoder_level2 = transformer_stack(NUM_BLOCKS[1], 2 * d, HEADS[1])
        self.up2_1 = Resample(2 * d, 4 * d)
        self.decoder_level1 = transformer_stack(NUM_BLOCKS[0], 2 * d, HEADS[0])
        self.decoder_level1_copy = transformer_stack(NUM_BLOCKS[0], 2 * d,
                                                     HEADS[0])
        self.output16 = nn.Conv2d(4 * d, 2 * d, 1, bias=False)


def extractor_forward(x, p: Extractor):
    """x: (B, 3, H, W) in [-1, 1]. Returns (outputs04, outputs08, outputs16,
    v): outputsNN are [head0, head1] over the FIRST half of the batch (the
    reference computes context heads for image1 only, extractor.py:325-340)
    and v is the full-batch 1/4 volume feature."""
    half = x.shape[0] // 2

    e1 = conv2d(F.pixel_unshuffle(x, 4), p.patch_embed.proj)  # 64 @ 1/4
    e1 = run_stack(e1, p.encoder_level1)
    e2 = run_stack(downsample(e1, p.down1_2), p.encoder_level2)    # 128 @ 1/8
    e3 = run_stack(downsample(e2, p.down2_3), p.encoder_level3)    # 256 @ 1/16
    latent = run_stack(downsample(e3, p.down3_4), p.latent)        # 512 @ 1/32

    d3 = torch.cat([upsample(latent, p.up4_3), e3], dim=1)          # 512
    d3 = conv2d(d3, p.reduce_chan_level3)                           # 256
    # outputs16 applies the SAME conv twice (extractor.py:295: the ModuleList
    # holds two references to output16), so both heads are one tensor.
    o16 = conv2d(d3[:half], p.output16)
    outputs16 = [o16, o16]
    d3 = run_stack(d3, p.decoder_level3)

    d2 = torch.cat([upsample(d3, p.up3_2), e2], dim=1)              # 256
    outputs08 = [conv2d(d2[:half], p.reduce_chan_level2),
                 conv2d(d2[:half], p.reduce_chan_level2_copy)]
    d2 = run_stack(conv2d(d2, p.reduce_chan_level2), p.decoder_level2)

    v = torch.cat([upsample(d2, p.up2_1), e1], dim=1)               # 128 @ 1/4
    outputs04 = [run_stack(v[:half], p.decoder_level1),
                 run_stack(v[:half], p.decoder_level1_copy)]
    return outputs04, outputs08, outputs16, v
