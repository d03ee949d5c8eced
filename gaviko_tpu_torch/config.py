"""Config system: YAML configs with the reference's group layout.

Port of ``gaviko_tpu/config.py``: the same five groups ``utils / data /
model / train / wandb``, the same ``--method`` surgery, and the same
``ModelSpec`` derived from ``config['model']``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import yaml

METHODS = (
    "gaviko", "fft", "linear", "adaptformer", "bitfit", "dvpt", "evp",
    "ssf", "melo", "deep_vpt", "shallow_vpt",
)

# Backbone geometry table (ref: src/utils/load_pretrained.py:103-118).
VIT_CONFIG_MAP = {
    "vit-b16": {"depth": 12, "heads": 12, "dim": 768, "mlp_dim": 3072},
    "vit-t16": {"depth": 12, "heads": 3, "dim": 192, "mlp_dim": 768},
    "vit-s16": {"depth": 12, "heads": 6, "dim": 384, "mlp_dim": 1536},
    "vit-l16": {"depth": 24, "heads": 16, "dim": 1024, "mlp_dim": 4096},
}


def mapping_vit(backbone: Optional[str]) -> Tuple[int, int, int, int]:
    """Backbone name -> (depth, heads, dim, mlp_dim)."""
    if backbone is None:
        raise ValueError("Backbone must be specified.")
    key = backbone.lower().replace("_", "-")
    if key not in VIT_CONFIG_MAP:
        raise ValueError(
            f"Unsupported backbone: {backbone}. Supported backbones are: "
            f"{list(VIT_CONFIG_MAP.keys())}"
        )
    c = VIT_CONFIG_MAP[key]
    return c["depth"], c["heads"], c["dim"], c["mlp_dim"]


def load_config(path: str) -> dict:
    """Load a YAML config. A path that doesn't exist on disk is retried
    against this package's ``configs/`` directory (by basename): copies of
    the JAX package's shipped YAMLs, byte for byte."""
    if not os.path.exists(path):
        packaged = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "configs", os.path.basename(path))
        if os.path.exists(packaged):
            path = packaged
    with open(path) as f:
        return yaml.safe_load(f)


def apply_method_override(config: dict, method: Optional[str]) -> dict:
    """CLI --method surgery. Ref: src/train.py:519-523."""
    if method is not None:
        config["model"]["method"] = method
    m = config["model"].get("method")
    if m == "deep_vpt":
        config["model"]["deep_prompt"] = True
    elif m == "shallow_vpt":
        config["model"]["deep_prompt"] = False
    return config


def _pair(t):
    return tuple(t) if isinstance(t, (tuple, list)) else (t, t)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static geometry + method hyperparameters (the JAX package's fields).

    Backbone dims always come from mapping_vit; the YAML's explicit
    dim/depth/heads entries are ignored, as the reference's ctors ignore them.
    """

    method: str
    # Geometry
    image_size: Tuple[int, int]
    image_patch_size: Tuple[int, int]
    frames: int
    frame_patch_size: int
    channels: int
    num_classes: int
    pool: str
    backbone: Optional[str]
    # Backbone dims (from mapping_vit)
    depth: int
    heads: int
    dim: int
    mlp_dim: int
    dim_head: int = 64
    # Dropout
    dropout: float = 0.0
    emb_dropout: float = 0.0
    # Freezing
    freeze_vit: bool = False
    fp16: bool = False
    gelu: str = "exact"
    # --- method-specific ---
    # vpt
    num_prompts: int = 8
    prompt_dim: int = 64
    prompt_dropout: float = 0.0
    deep_prompt: bool = True
    # gaviko
    prompt_latent_dim: int = 20
    local_dim: int = 20
    local_k: Tuple[int, int, int] = (3, 6, 6)
    DHW: Tuple[int, int, int] = (10, 10, 10)
    attn_drop: float = 0.2
    proj_drop: float = 0.2
    share_factor: int = 1
    # melo (LoRA)
    r: int = 4
    alpha: int = 4
    lora_layers: Optional[Tuple[int, ...]] = None
    # evp
    scale_factor: int = 32
    input_type: str = "fft"
    freq_nums: float = 0.25
    handcrafted_tune: bool = True
    embedding_tune: bool = True

    @property
    def grid_dhw(self) -> Tuple[int, int, int]:
        """Patch-grid shape (D', H', W')."""
        ih, iw = self.image_size
        ph, pw = self.image_patch_size
        return (self.frames // self.frame_patch_size, ih // ph, iw // pw)

    @property
    def num_patches(self) -> int:
        d, h, w = self.grid_dhw
        return d * h * w

    @property
    def patch_dim(self) -> int:
        ph, pw = self.image_patch_size
        return self.channels * ph * pw * self.frame_patch_size


def make_spec(model_cfg: dict) -> ModelSpec:
    """Build a ModelSpec from ``config['model']``."""
    method = model_cfg.get("method", "gaviko")
    backbone = model_cfg.get("backbone")
    depth, heads, dim, mlp_dim = mapping_vit(backbone)

    image_size = _pair(model_cfg["image_size"])
    image_patch_size = _pair(model_cfg["image_patch_size"])
    frames = model_cfg["frames"]
    frame_patch_size = model_cfg["frame_patch_size"]
    ih, iw = image_size
    ph, pw = image_patch_size
    if ih % ph or iw % pw:
        raise ValueError("Image dimensions must be divisible by the patch size.")
    if frames % frame_patch_size:
        raise ValueError("Frames must be divisible by frame patch size")
    pool = model_cfg.get("pool", "cls")
    if pool not in {"cls", "mean"}:
        raise ValueError(
            "pool type must be either cls (cls token) or mean (mean pooling)")

    kw: dict[str, Any] = {}
    if method == "gaviko":
        # DHW defaults to the actual patch grid; an explicit config value is
        # validated against the token count up front.
        grid = (frames // frame_patch_size, ih // ph, iw // pw)
        dhw = tuple(model_cfg.get("DHW", grid))
        if dhw[0] * dhw[1] * dhw[2] != grid[0] * grid[1] * grid[2]:
            raise ValueError(
                f"model.DHW {dhw} does not match the patch grid {grid} "
                f"(frames/frame_patch_size, image_size/image_patch_size x2): "
                f"GAViKO's local attention needs prod(DHW) == token count."
            )
        kw.update(
            num_prompts=model_cfg.get("num_prompts", 8),
            prompt_latent_dim=model_cfg.get("prompt_latent_dim", 20),
            local_dim=model_cfg.get("local_dim", 20),
            local_k=tuple(model_cfg.get("local_k", (3, 6, 6))),
            DHW=dhw,
            attn_drop=model_cfg.get("attn_drop", 0.2),
            proj_drop=model_cfg.get("proj_drop", 0.2),
            share_factor=model_cfg.get("share_factor", 1),
        )
    elif method in ("deep_vpt", "shallow_vpt"):
        kw.update(
            num_prompts=model_cfg.get("num_prompts", 8),
            prompt_dim=model_cfg.get("prompt_dim", 64),
            prompt_dropout=model_cfg.get("prompt_dropout", 0.0),
            deep_prompt=model_cfg.get("deep_prompt", method == "deep_vpt"),
        )
    elif method == "dvpt":
        kw.update(num_prompts=model_cfg.get("num_prompts", 50))
    elif method == "melo":
        lora_layers = model_cfg.get("lora_layers")
        kw.update(
            r=model_cfg.get("r", 4),
            alpha=model_cfg.get("alpha", 4),
            lora_layers=tuple(lora_layers) if lora_layers else None,
        )
    elif method == "evp":
        kw.update(
            scale_factor=model_cfg.get("scale_factor", 32),
            input_type=model_cfg.get("input_type", "fft"),
            freq_nums=model_cfg.get("freq_nums", 0.25),
            handcrafted_tune=model_cfg.get("handcrafted_tune", True),
            embedding_tune=model_cfg.get("embedding_tune", True),
        )

    return ModelSpec(
        method=method,
        image_size=image_size,
        image_patch_size=image_patch_size,
        frames=frames,
        frame_patch_size=frame_patch_size,
        channels=model_cfg.get("channels", 1),
        num_classes=model_cfg["num_classes"],
        pool=pool,
        backbone=backbone,
        depth=depth,
        heads=heads,
        dim=dim,
        mlp_dim=mlp_dim,
        dim_head=model_cfg.get("dim_head", 64),
        dropout=model_cfg.get("dropout", 0.0),
        emb_dropout=model_cfg.get("emb_dropout", 0.0),
        freeze_vit=model_cfg.get("freeze_vit", False),
        fp16=model_cfg.get("fp16", False),
        gelu=_validated_gelu(model_cfg.get("gelu", "exact")),
        **kw,
    )


def _validated_gelu(mode: str) -> str:
    allowed = ("exact", "tanh", "erf_fast")
    if mode not in allowed:
        raise ValueError(f"model.gelu must be one of {allowed}, got {mode!r}")
    return mode
