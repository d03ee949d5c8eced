"""EVP: explicit visual prompting from high-pass-FFT hand-crafted features.

Port of ``gaviko_tpu/models/evp.py`` (ref: src/model/evp.py). Two feature
streams feed a prompt for each layer:

- ``embedding_generator``: the patch embed's output projected dim ->
  dim / scale_factor;
- the hand-crafted stream: a high-pass FFT of the raw volume
  (:func:`fft_highpass`) through a second patch embed at dim /
  scale_factor (192 columns at vit-b16 and ``scale_factor`` 4).

Layer i's ``lightweight_mlp_i`` (Linear + GELU) and the shared
up-projection turn their sum into prompt i, which is ADDED to the non-cls
rows before layer i. Both patch embeds run the patchify kernel; the conv
params are named ``conv_proj.proj.*``, the reference's PatchEmbed.

Reproduced reference behaviours (as in the JAX package):
- the FFT mask indexes dims (2, 3) = (D, H) with extents from the last two
  dims (H, W), and ``fftshift`` / ``ifftshift`` run over ALL axes, the
  batch included;
- in bf16 the FFT computes in f32 (JAX's ``fft2`` of bf16 returns
  complex64; ``torch.fft`` refuses bf16, so the volume is cast first), the
  f32 hand-crafted feature promotes the prompts, and ``prompts[i] + x``
  turns the whole stream f32 from layer 0 on while the weights stay bf16:
  JAX's bf16 EVP runs its transformer in f32, with bf16 weights promoted
  where they meet the stream, and returns f32 logits. The port keeps that
  (``core/layers.linear`` / ``proj`` promote as JAX does);
- ``PromptGenerator.forward`` is dead code in the reference and has no
  counterpart; ``init_head_weights`` is never invoked, so the head keeps
  torch's default init.

With ``freeze_vit`` the backbone stays in eval and a train step draws no
seed. The last layer runs CLS-query only where ``cls_fast_enabled`` holds.
"""

from __future__ import annotations

from typing import Optional

import torch

from gaviko_tpu_torch.config import ModelSpec
from gaviko_tpu_torch.core import init as tinit
from gaviko_tpu_torch.core import vit as vit_core
from gaviko_tpu_torch.core.layers import (
    Params, SeedStream, dropout, gelu, layer_norm, linear)


def fft_highpass(x: torch.Tensor, rate: float) -> torch.Tensor:
    """High-pass filter in the shifted frequency domain (ref: evp.py:126-147);
    f32 for a bf16 or f32 input."""
    w, h = x.shape[-2], x.shape[-1]
    line = int((w * h * rate) ** 0.5 // 2)
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    keep = torch.ones(x.shape, dtype=xf.dtype, device=x.device)
    # Reference quirk: dims 2 and 3 (D, H for a 5D volume), extents from (H, W).
    keep[:, :, w // 2 - line: w // 2 + line, h // 2 - line: h // 2 + line] = 0.0
    f = torch.fft.fftshift(torch.fft.fft2(xf, norm="forward"))  # over ALL axes
    f = torch.fft.ifftshift(f * keep)
    return torch.fft.ifft2(f, norm="forward").real.abs()


def apply(params: Params, img: torch.Tensor, spec: ModelSpec, *,
          train: bool = False, seeds: Optional[SeedStream] = None) -> torch.Tensor:
    bb_train = train and not spec.freeze_vit
    x = vit_core.patchify_embed(params, "conv_proj.proj", img, spec)

    emb_feature = linear(params, "prompt_generator.embedding_generator", x)
    hand = fft_highpass(img, spec.freq_nums)
    hand_feature = vit_core.patchify_embed(
        params, "prompt_generator.prompt_generator.proj", hand, spec)
    base = hand_feature + emb_feature
    shared = [linear(params, "prompt_generator.shared_mlp",
                     gelu(linear(params, f"prompt_generator.lightweight_mlp_{i}.0", base)))
              for i in range(spec.depth)]

    x = vit_core.add_cls_and_pos(params, x)
    x = dropout(x, spec.emb_dropout, bb_train, seeds)
    fast = vit_core.cls_fast_enabled(spec)
    for i in range(spec.depth):
        rest = shared[i] + x[:, 1:]
        x = torch.cat([x[:, :1].to(rest.dtype), rest], dim=1)
        a, f = f"transformer.layers.{i}.0", f"transformer.layers.{i}.1"
        if fast and i == spec.depth - 1:
            c = x[:, 0] + vit_core.attention_cls_branch(
                params, a, x, spec, n_true=x.shape[1], train=bb_train, seeds=seeds)
            c = c + vit_core.feedforward_cls_branch(params, f, c, spec, train=bb_train,
                                                    seeds=seeds)
            return linear(params, "mlp_head", layer_norm(params, "transformer.norm", c))
        x = vit_core.attention_block(params, a, x, spec, train=bb_train, seeds=seeds) + x
        x = vit_core.feedforward_block(params, f, x, spec, train=bb_train, seeds=seeds) + x
    x = layer_norm(params, "transformer.norm", x)
    return vit_core.pool_and_head(params, x, spec)


def init(gen: torch.Generator, spec: ModelSpec) -> Params:
    """Random f32 params on ``gen``'s device under the reference's names.
    The prompt generator's Linears take timm's truncated normal (std .02)
    and zero biases; its Conv3d keeps torch's default (the reference's
    ``_init_weights`` hook handles Conv2d only)."""
    dev = gen.device
    p: Params = {k.replace("conv_proj.0.", "conv_proj.proj."): v
                 for k, v in vit_core.vit_init(gen, spec).items()}
    dim = spec.dim
    low = dim // spec.scale_factor
    kdhw = (spec.frame_patch_size, *spec.image_patch_size)
    g = "prompt_generator"
    p[f"{g}.shared_mlp.weight"] = tinit.timm_style_trunc_normal(gen, (dim, low))
    p[f"{g}.shared_mlp.bias"] = torch.zeros(dim, device=dev)
    p[f"{g}.embedding_generator.weight"] = tinit.timm_style_trunc_normal(gen, (low, dim))
    p[f"{g}.embedding_generator.bias"] = torch.zeros(low, device=dev)
    for i in range(spec.depth):
        p[f"{g}.lightweight_mlp_{i}.0.weight"] = tinit.timm_style_trunc_normal(gen, (low, low))
        p[f"{g}.lightweight_mlp_{i}.0.bias"] = torch.zeros(low, device=dev)
    p[f"{g}.prompt_generator.proj.weight"] = tinit.torch_conv3d_weight(
        gen, low, spec.channels, kdhw)
    p[f"{g}.prompt_generator.proj.bias"] = tinit.torch_conv3d_bias(gen, low, spec.channels, kdhw)
    return p
