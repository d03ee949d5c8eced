"""timm -> GAViKO-name weight conversion (the parity-critical path).

Port of ``gaviko_tpu/weights/convert.py``, the same numpy arithmetic, so both
packages convert a timm file to the same flat dict. It replicates
src/utils/load_pretrained.py:8-99:
- key remap: blocks.N.norm1/attn.qkv/attn.proj -> transformer.attns.N.{norm,
  to_qkv,to_out.0}; blocks.N.norm2/mlp.fc1/fc2 -> transformer.mlps.N.{net.0,
  net.1,net.4}; patch_embed.proj -> conv_proj.0 (with kernel inflation);
  pos_embed -> pos_embedding (2D->3D trilinear); norm.* -> transformer.norm.*.
- pos-embed interpolation: 14x14 grid -> cbrt(num_patches)^3 via trilinear,
  align_corners=False, cls row passed through (load_pretrained.py:34-44).
- patch-kernel inflation: mean over RGB -> repeat over depth
  (load_pretrained.py:46-51).

Reference behaviours kept (SURVEY.md §3.5, PARITY #3/#4): the emitted
``...to_qkv.bias`` keys have no destination param (the reference's
Attention has bias=False), and the ``transformer.attns/mlps`` names only
match GAViKO's layout; both drop at load time in
``state_dict.load_state_dict``'s name intersection, as torch strict=False
drops them.

``load_pretrain`` reads a local timm-format state dict (.pt through torch,
or .npz); nothing is downloaded. ``synthetic_timm_state`` makes a stand-in
with timm's exact key inventory and shapes, values from a seed.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

TIMM_MODEL_NAMES = {
    "vit-b16": "vit_base_patch16_224_in21k",
    "vit-t16": "vit_tiny_patch16_224_in21k",
    "vit-s16": "vit_small_patch16_224_in21k",
    "vit-l16": "vit_large_patch16_224_in21k",
}

# (width, depth) of each timm in21k ViT.
TIMM_WIDTHS = {"vit-t16": (192, 12), "vit-s16": (384, 12), "vit-b16": (768, 12),
               "vit-l16": (1024, 24)}


def synthetic_timm_state(backbone: str, seed: int = 0,
                         depth: Optional[int] = None) -> Dict[str, np.ndarray]:
    """timm's ``<backbone>_patch16_224_in21k`` inventory (every key and shape,
    ``pre_logits.fc`` and the 21,843-way head included), its first ``depth``
    blocks (all by default), float32 values from ``seed``: weights and biases
    N(0, 0.02^2), norm weights 1 + N(0, 0.02^2). For tests and smoke runs
    where no downloaded file is at hand."""
    dim, full_depth = TIMM_WIDTHS[backbone]
    shapes = {"cls_token": (1, 1, dim), "pos_embed": (1, 197, dim),
              "patch_embed.proj.weight": (dim, 3, 16, 16), "patch_embed.proj.bias": (dim,)}
    for i in range(full_depth if depth is None else depth):
        b = f"blocks.{i}"
        shapes.update({f"{b}.norm1.weight": (dim,), f"{b}.norm1.bias": (dim,),
                       f"{b}.attn.qkv.weight": (3 * dim, dim),
                       f"{b}.attn.qkv.bias": (3 * dim,),
                       f"{b}.attn.proj.weight": (dim, dim), f"{b}.attn.proj.bias": (dim,),
                       f"{b}.norm2.weight": (dim,), f"{b}.norm2.bias": (dim,),
                       f"{b}.mlp.fc1.weight": (4 * dim, dim), f"{b}.mlp.fc1.bias": (4 * dim,),
                       f"{b}.mlp.fc2.weight": (dim, 4 * dim), f"{b}.mlp.fc2.bias": (dim,)})
    shapes.update({"norm.weight": (dim,), "norm.bias": (dim,),
                   "pre_logits.fc.weight": (dim, dim), "pre_logits.fc.bias": (dim,),
                   "head.weight": (21843, dim), "head.bias": (21843,)})
    rng = np.random.default_rng(seed)
    state = {}
    for k, shape in shapes.items():
        v = rng.standard_normal(shape, dtype=np.float32)
        v *= np.float32(0.02)
        if k.endswith(("norm.weight", "norm1.weight", "norm2.weight")):
            v += np.float32(1.0)
        state[k] = v
    return state


def _linterp_axis(x: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """1D linear resample along ``axis`` with torch align_corners=False
    semantics (half-pixel centers, border clamp)."""
    in_size = x.shape[axis]
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    w = (src - i0).astype(x.dtype)
    i0c = np.clip(i0, 0, in_size - 1)
    i1c = np.clip(i0 + 1, 0, in_size - 1)
    a = np.take(x, i0c, axis=axis)
    b = np.take(x, i1c, axis=axis)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = w.reshape(shape)
    return a * (1 - w) + b * w


def trilinear_resize(x: np.ndarray, out_dhw) -> np.ndarray:
    """[.., D, H, W] -> [.., D', H', W'], matching F.interpolate(trilinear,
    align_corners=False) — separable linear resampling."""
    nd = x.ndim
    for axis, size in zip((nd - 3, nd - 2, nd - 1), out_dhw):
        x = _linterp_axis(x, axis, size)
    return x


def interpolate_pos_embedding(pos_embed: np.ndarray, num_patches: int) -> np.ndarray:
    """(1, 1+P_old, dim) -> (1, 1+num_patches, dim) (ref: load_pretrained.py:34-44)."""
    cls_tok = pos_embed[:, :1, :]
    grid = pos_embed[:, 1:, :]
    old = int(grid.shape[1] ** 0.5)
    new = round(num_patches ** (1.0 / 3.0))
    g = grid.reshape(1, old, old, -1).transpose(0, 3, 1, 2)  # [1, dim, 14, 14]
    g = g[:, :, None, :, :]  # [1, dim, 1, 14, 14]
    g = trilinear_resize(g, (new, new, new))  # [1, dim, n, n, n]
    g = g.transpose(0, 2, 3, 4, 1).reshape(1, new ** 3, -1)
    return np.concatenate([cls_tok, g], axis=1)


def mean_kernel(patch_emb_weight: np.ndarray, depth_dim: int) -> np.ndarray:
    """(dim, 3, 16, 16) -> (dim, 1, depth, 16, 16) (ref: load_pretrained.py:46-51)."""
    w = patch_emb_weight.mean(axis=1, keepdims=True)  # mean over RGB
    w = np.repeat(w[:, :, None, :, :], depth_dim, axis=2)
    return w


def convert_timm_state(
    timm_state: Mapping[str, np.ndarray], num_patches: int, depth_dim: int
) -> Dict[str, np.ndarray]:
    """The per-key remap loop (ref: load_pretrained.py:63-98)."""
    new: Dict[str, np.ndarray] = {}

    def add(key, value, kind="plain"):
        repl = {
            "plain": "transformer",
            "attn": "transformer.attns",
            "mlp": "transformer.mlps",
        }[kind]
        new[key.replace("blocks", repl)] = np.asarray(value)

    for key, value in timm_state.items():
        value = np.asarray(value)
        if key == "cls_token":
            new[key] = value
        elif "norm1" in key:
            add(key.replace("norm1", "norm"), value, "attn")
        elif "attn.qkv" in key:
            # Emits to_qkv.bias too; dropped downstream (no destination).
            add(key.replace("attn.qkv", "to_qkv"), value, "attn")
        elif "attn.proj" in key:
            add(key.replace("attn.proj", "to_out.0"), value, "attn")
        elif "norm2" in key:
            add(key.replace("norm2", "net.0"), value, "mlp")
        elif "mlp.fc1" in key:
            add(key.replace("mlp.fc1", "net.1"), value, "mlp")
        elif "mlp.fc2" in key:
            add(key.replace("mlp.fc2", "net.4"), value, "mlp")
        elif "patch_embed.proj.weight" in key:
            add(
                key.replace("patch_embed.proj.weight", "conv_proj.0.weight"),
                mean_kernel(value, depth_dim),
            )
        elif "patch_embed.proj.bias" in key:
            add(key.replace("patch_embed.proj.bias", "conv_proj.0.bias"), value)
        elif key == "pos_embed":
            add("pos_embedding", interpolate_pos_embedding(value, num_patches))
        elif key == "norm.weight":
            add("transformer.norm.weight", value)
        elif key == "norm.bias":
            add("transformer.norm.bias", value)
    return new


def _read_state_file(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def load_pretrain(
    backbone: str, num_patches: int, depth_dim: int, save_dir: str
) -> Dict[str, np.ndarray]:
    """Offline equivalent of load_pretrained.load_pretrain: reads the timm
    state dict from ``save_dir/<timm_name>{,.pt,.npz}`` (the same location the
    reference caches its download — load_pretrained.py:27-28) and converts.
    Raises FileNotFoundError with guidance when absent (no network here)."""
    name = TIMM_MODEL_NAMES.get(backbone.lower().replace("_", "-"))
    if name is None:
        raise ValueError(f"Unsupported backbone: {backbone}")
    for cand in (name, name + ".pt", name + ".npz"):
        path = os.path.join(save_dir, cand)
        if os.path.exists(path):
            return convert_timm_state(_read_state_file(path), num_patches, depth_dim)
    raise FileNotFoundError(
        f"No pretrained weights for {backbone} under {save_dir} (expected "
        f"{name}[.pt|.npz]). Nothing is downloaded: place a timm-format state "
        f"dict there, or run with backbone weights omitted."
    )


def main():
    """CLI: convert a timm-format state dict to this framework's names.

        python -m gaviko_tpu_torch.weights.convert <timm_state.pt|.npz> \
            --backbone vit-b16 --out converted.npz \
            [--num-patches 1000] [--depth-dim 12]
    """
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("timm_state")
    parser.add_argument("--backbone", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--num-patches", type=int, default=1000)
    parser.add_argument("--depth-dim", type=int, default=12,
                        help="frame_patch_size (depth of the inflated kernel)")
    args = parser.parse_args()
    state = _read_state_file(args.timm_state)
    conv = convert_timm_state(state, args.num_patches, args.depth_dim)
    if args.out.endswith(".npz"):
        np.savez(args.out, **conv)
    else:
        from gaviko_tpu_torch.weights.torch_io import save_pt

        save_pt(args.out, {k: torch.from_numpy(v) for k, v in conv.items()})
    print(f"wrote {len(conv)} tensors -> {args.out}")


if __name__ == "__main__":
    main()
