"""Runtime configuration: one dataclass with environment-variable
overrides — a copy of ``planer_tpu/utils/config.py`` with the same fields.
Every field can be overridden by a ``PLANER_<FIELD>`` env var; per-op
configuration stays in the IR kwargs.  The mesh fields wait for the port's
``parallel`` package and are not read yet.
"""
from __future__ import annotations

import dataclasses
import os

__all__ = ["Config", "get_config", "set_config"]


@dataclasses.dataclass
class Config:
    # precision policy of the program
    compute_dtype: str = "float32"       # activations' dtype in the program
    quant_mode: str = "int8"             # default for Net.quantize()
    # mesh defaults (parallel.make_mesh when shape unspecified)
    mesh_data: int = 0                   # 0 = all devices on data axis
    mesh_model: int = 1
    # tiled-inference defaults (utils.tile)
    tile_window: int = 1024
    tile_margin: float = 0.1
    # serving defaults
    serve_buckets: tuple = (1, 2, 4, 8, 16, 32)
    serve_max_delay_ms: float = 5.0
    # where the kernels' built libraries go (empty = the default build dir)
    compile_cache_dir: str = ""

    @staticmethod
    def from_env() -> "Config":
        cfg = Config()
        for f in dataclasses.fields(Config):
            env = os.environ.get(f"PLANER_{f.name.upper()}")
            if env is None:
                continue
            if f.type in ("int",):
                setattr(cfg, f.name, int(env))
            elif f.type in ("float",):
                setattr(cfg, f.name, float(env))
            elif f.type in ("tuple",):
                setattr(cfg, f.name, tuple(int(x) for x in env.split(",")))
            else:
                setattr(cfg, f.name, env)
        return cfg

    def apply(self):
        """Apply process-level settings.  The port's compiled artifacts are
        the nvcc- and g++-built kernel libraries: ``compile_cache_dir``
        becomes their build directory (``PLANER_TORCH_BUILD_DIR``, read by
        ``ops.kernels.build`` and ``native`` at each build or load)."""
        if self.compile_cache_dir:
            os.environ["PLANER_TORCH_BUILD_DIR"] = self.compile_cache_dir
        return self


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def set_config(cfg: Config) -> Config:
    global _config
    _config = cfg
    return cfg
