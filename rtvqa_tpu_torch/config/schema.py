"""Config loading + validation (the port's own copy of
``rtvqa_tpu/config/schema.py``; same keys, defaults and checks, so one
config file drives either package).

Superset of the reference config schema (``config.json:1-7``, validation at
``video_processing.py:71-98`` of the original project). Differences, all
deliberate (SURVEY.md §2.4):

* ``num_workers`` is accepted *and honoured* (reference validates it but never
  threads it through — ``video_processing.py:97`` vs ``:242-247``); here it
  bounds host-side decode parallelism.
* new keys: ``batch_size``, ``smoothing_alpha`` (hard-coded 0.8 in the
  reference, ``complexity_metrics.py:114``), ``analyze_original`` (the
  reference always analyzes the *encoded* video, ``video_processing.py:234``),
  ``csv_file``, ``preset``, ``quality_backend``, ``data_parallel_devices``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional


class ConfigError(ValueError):
    """Raised when a config file fails validation."""


# The libx264 preset set (x264 --fullhelp; passed through to the in-process
# encoder in io/video.py).
_X264_PRESETS = frozenset(
    {
        "ultrafast", "superfast", "veryfast", "faster", "fast",
        "medium", "slow", "slower", "veryslow", "placebo",
    }
)


@dataclasses.dataclass(frozen=True)
class Config:
    # --- reference-compatible keys (config.json:1-7) ---
    crf: int = 23
    vmaf_model_path: Optional[str] = None
    resize_width: int = 64
    resize_height: int = 64
    frame_interval: int = 10
    num_workers: Optional[int] = None
    # --- extensions ---
    batch_size: int = 128
    smoothing_alpha: float = 0.8
    analyze_original: bool = False
    csv_file: str = "video_quality_data.csv"
    preset: str = "medium"
    # "native" = on-device PSNR/SSIM/VMAF; "none" = skip quality metrics.
    quality_backend: str = "native"
    # Without a real libvmaf model file (vmaf_model_path) the predictor falls
    # back to an invented builtin model whose scores are NOT libvmaf-parity.
    # By default the CSV "VMAF" cell is left empty in that case; set this to
    # true to opt in to writing the builtin fallback score.
    allow_builtin_vmaf: bool = False
    # Devices used by the sharded paths (run_sweep_sharded /
    # analyze_clips_sharded): mesh size = min(this, local devices).
    # None = all local devices.
    data_parallel_devices: Optional[int] = None
    # Streaming (bounded-memory) complexity analysis: True/False, or None =
    # auto (streams when the analyzed file exceeds ~256 MB).
    streaming_complexity: Optional[bool] = None
    # VIF/VMAF filter precision: "auto" (default) and "exact" run exact f32
    # in the port; "fast" (the JAX package's reduced-precision mode) is not
    # ported and raises. PSNR/SSIM are exact in every mode.
    quality_precision: Optional[str] = None
    # Motion-complexity block-matching search: "pyramid" (default — half-res
    # coarse search, the reference Farneback's own pyramid analog, ~14x less
    # arithmetic) or "full" (exhaustive full-resolution). docs/PARITY.md.
    motion_search: str = "pyramid"

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ConfigError(f"Unknown config keys: {sorted(unknown)}")
        cfg = cls(**raw)
        cfg.validate()
        return cfg

    @classmethod
    def from_file(cls, path: str) -> "Config":
        try:
            with open(path, "r") as f:
                raw = json.load(f)
        except FileNotFoundError:
            raise ConfigError(f"Configuration file {path} not found.")
        except json.JSONDecodeError as e:
            raise ConfigError(f"Error decoding JSON from configuration file {path}: {e}")
        return cls.from_dict(raw)

    def validate(self) -> None:
        # Mirrors reference range checks (video_processing.py:87-98).
        if not (1 <= self.crf <= 51):
            raise ConfigError("CRF value must be between 1 and 51.")
        if self.resize_width <= 0 or self.resize_height <= 0:
            raise ConfigError("Resize dimensions must be positive integers.")
        if self.frame_interval <= 0:
            raise ConfigError("Frame interval must be a positive integer.")
        if self.num_workers is not None and not isinstance(self.num_workers, int):
            raise ConfigError("num_workers must be an integer.")
        if self.batch_size <= 0:
            raise ConfigError("batch_size must be a positive integer.")
        if not (0.0 < self.smoothing_alpha <= 1.0):
            raise ConfigError("smoothing_alpha must be in (0, 1].")
        if self.quality_backend not in ("native", "none"):
            raise ConfigError("quality_backend must be 'native' or 'none'.")
        if self.data_parallel_devices is not None and self.data_parallel_devices <= 0:
            raise ConfigError("data_parallel_devices must be a positive integer.")
        if self.streaming_complexity is not None and not isinstance(
            self.streaming_complexity, bool
        ):
            raise ConfigError("streaming_complexity must be a boolean or null.")
        if self.motion_search not in ("pyramid", "full"):
            raise ConfigError(
                f"motion_search must be 'pyramid' or 'full', got "
                f"{self.motion_search!r}."
            )
        if self.quality_precision not in (None, "auto", "exact", "fast"):
            raise ConfigError(
                "quality_precision must be 'auto', 'exact', 'fast' or null, "
                f"got {self.quality_precision!r}."
            )
        if self.preset not in _X264_PRESETS:
            # Catch preset typos here rather than as an opaque x264 error
            # mid-pipeline (VERDICT r2 weak #5).
            raise ConfigError(
                f"preset must be one of {sorted(_X264_PRESETS)}, got {self.preset!r}."
            )


def load_config(config_file: str) -> Config:
    """Load and validate a JSON config (reference: video_processing.py:71-84)."""
    return Config.from_file(config_file)
