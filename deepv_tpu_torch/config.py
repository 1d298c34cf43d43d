"""Configuration dataclasses for the PyTorch port (a copy of deepv_tpu's
``config.py``, kept here so the port imports nothing of the JAX package).

Capability parity with the reference two-tier config system: a pipeline-level
dict built by ``create_model_config`` (ref run.py:14-51) plus per-model
hyperparameters that the reference reads from checkpoint ``config.json`` files
(ref mmdit.py:1163, vae.py:756, scheduler.py:47). Here both tiers are typed
dataclasses; ``from_json`` classmethods consume HF-format ``config.json``
files so converted checkpoints keep working.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """MMDiT denoiser hyperparameters (ref mmdit.py:1163-1186).

    The reference defaults to ``in_channels=16`` but the deployed DeepVerse
    checkpoint uses 38 = 16 (rgb latent) + 16 (disparity latent) + 6 (raymap);
    we default to the deployed value.
    """

    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 38
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192
    qk_norm: str = "rms_norm"
    pos_embed_type: str = "sincos"          # spatial: cropped sincos (SD3 style)
    temp_pos_embed_type: str = "rope"        # temporal: axis RoPE
    joint_attention_dim: int = 4096
    use_temporal_causal: bool = True
    interp_condition_pos: bool = True

    def __post_init__(self):
        # The deployed behaviour is hard-coded to these values; a checkpoint
        # config requesting anything else must fail loudly instead of being
        # silently ignored. (The reference itself raises NotImplementedError
        # on the spatial-RoPE path, ref mmdit.py:1388-1390, and supports no
        # non-causal variant at inference.)
        if self.qk_norm != "rms_norm":
            raise NotImplementedError(f"qk_norm={self.qk_norm!r}: only 'rms_norm'")
        if self.pos_embed_type != "sincos":
            raise NotImplementedError(
                f"pos_embed_type={self.pos_embed_type!r}: only 'sincos' (the "
                "reference's spatial-RoPE path is itself NotImplementedError)")
        if self.temp_pos_embed_type != "rope":
            raise NotImplementedError(
                f"temp_pos_embed_type={self.temp_pos_embed_type!r}: only 'rope'")
        if not self.use_temporal_causal:
            raise NotImplementedError("use_temporal_causal=False is unsupported")

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def out_channels(self) -> int:
        return self.in_channels

    @classmethod
    def from_json(cls, path: str) -> "MMDiTConfig":
        with open(path) as f:
            raw = json.load(f)
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in keys})

    @classmethod
    def tiny(cls) -> "MMDiTConfig":
        """A tiny config for unit tests and CPU dry runs."""
        return cls(
            sample_size=16, patch_size=2, in_channels=6, num_layers=2,
            attention_head_dim=8, num_attention_heads=4,
            caption_projection_dim=32, pooled_projection_dim=16,
            pos_embed_max_size=32, joint_attention_dim=24,
        )


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Causal video VAE hyperparameters (ref vae.py:756-793).

    Reference code defaults disable temporal down/upsampling, but the deployed
    checkpoint enables 8x temporal compression (57 pixel frames <-> 8 latent
    frames: 1 + 56/8); we default to the deployed topology.
    """

    encoder_in_channels: int = 3
    encoder_out_channels: int = 16
    encoder_layers_per_block: Tuple[int, ...] = (2, 2, 2, 2)
    encoder_block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    encoder_spatial_down_sample: Tuple[bool, ...] = (True, True, True, False)
    encoder_temporal_down_sample: Tuple[bool, ...] = (False, True, True, True)
    encoder_norm_num_groups: int = 32

    decoder_in_channels: int = 16
    decoder_out_channels: int = 3
    decoder_layers_per_block: Tuple[int, ...] = (3, 3, 3, 3)
    decoder_block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    decoder_spatial_up_sample: Tuple[bool, ...] = (True, True, True, False)
    decoder_temporal_up_sample: Tuple[bool, ...] = (True, True, True, False)
    decoder_norm_num_groups: int = 32

    sample_size: int = 256
    downsample_scale: int = 8
    scaling_factor: float = 0.18215

    #: conv backend for eligible 3x3x3 stride-1 layers. The names are the
    #: JAX package's: "xla" is the library convolution (``F.conv3d`` here,
    #: the default); "igemm" (the hand-written implicit-GEMM kernel) and
    #: "int8" are not ported yet, and the pipeline raises
    #: NotImplementedError for them. Runtime knob, not a checkpoint
    #: hyperparameter.
    conv_impl: str = "xla"

    def __post_init__(self):
        # same fail-loudly rule as MMDiTConfig: a misspelled impl must not
        # silently run the default path
        if self.conv_impl not in ("xla", "igemm", "int8"):
            raise ValueError(
                f"conv_impl={self.conv_impl!r}: expected 'xla', 'igemm' or 'int8'")

    @classmethod
    def from_json(cls, path: str) -> "VAEConfig":
        with open(path) as f:
            raw = json.load(f)
        keys = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in raw.items():
            if k in keys:
                kwargs[k] = tuple(v) if isinstance(v, list) else v
        return cls(**kwargs)

    @classmethod
    def tiny(cls) -> "VAEConfig":
        """Tiny topology (same structure, fewer channels) for tests."""
        return cls(
            encoder_out_channels=4,
            encoder_layers_per_block=(1, 1, 1, 1),
            encoder_block_out_channels=(8, 8, 16, 16),
            encoder_norm_num_groups=4,
            decoder_in_channels=4,
            decoder_layers_per_block=(1, 1, 1, 1),
            decoder_block_out_channels=(8, 8, 16, 16),
            decoder_norm_num_groups=4,
            sample_size=32,
        )


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Pyramid flow-matching schedule (ref scheduler.py:47-68, run.py:27-31)."""

    num_train_timesteps: int = 1000
    shift: float = 1.0
    stages: int = 3
    stage_range: Tuple[float, ...] = (0.0, 1.0 / 3, 2.0 / 3, 1.0)
    gamma: float = 0.3333


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Pipeline-level knobs (ref run.py:14-51 create_model_config)."""

    model_path: str = "./ckpts"
    raymap_dim: int = 6
    max_temporal_length: int = 8          # latent units per chunk
    frame_per_unit: int = 1
    stages: Tuple[int, ...] = (1, 2, 4)   # pyramid downsample factors
    num_inference_steps: int = 5
    guidance_scale: float = 4.0           # ref pipeline.py:308
    video_guidance_scale: float = 3.5
    history_guidance_scale: float = 6.0
    history_downsample_ratio: int = 2
    vae_downsample: int = 8
    use_motion_prompt: bool = True
    no_need_depth: bool = False
    text_embeds_path: Optional[str] = None

    # rollout geometry (ref pipeline.py:266-270)
    num_input_image: int = 25             # pixel frames carried between chunks
    num_input_unit: int = 4               # latent units carried between chunks

    # VAE latent normalisation constants (ref pipeline.py:194-201)
    vae_shift_factor: float = 0.1490
    vae_scale_factor: float = 1.0 / 1.8415
    vae_video_shift_factor: float = -0.2343
    vae_video_scale_factor: float = 1.0 / 3.0986
    raymap_mean: Tuple[float, ...] = (-0.0016, -0.0010, 0.9015, 0.0313, -0.0538, 0.2079)
    raymap_std: Tuple[float, ...] = (0.3333, 0.2567, 0.0927, 0.4338, 0.1746, 0.5802)

    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)

    @property
    def actual_frame(self) -> int:
        """Pixel frames per chunk: (units-1)*8+1 = 57 (ref pipeline.py:266)."""
        return (self.max_temporal_length - 1) * self.vae_downsample + 1


def create_model_config(model_path: str = "./ckpts", **overrides) -> PipelineConfig:
    """Build the default DeepVerse pipeline config (ref run.py:14-51)."""
    defaults = dict(
        model_path=model_path,
        text_embeds_path=os.path.join(model_path, "text_embeds_len77.pt"),
    )
    defaults.update(overrides)
    return PipelineConfig(**defaults)
