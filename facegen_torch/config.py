"""Run configuration of the port's sampler.

Fields of facegen/config.py:SampleConfig (flags of ``th sample.lua``),
copied rather than imported: importing facegen pulls in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """scale/grayscale/noise_dim default to None, meaning "use the
    checkpoint's stored config"; explicit values are checked overrides
    (models/gan.py:restore_gan)."""

    save: str = "logs"            # --save_base (checkpoint dir)
    network: str = "adversarial"  # --G_base (checkpoint name)
    d_network: Optional[str] = None  # --D_base: D from another checkpoint
    batch_size: int = 32
    noise_dim: Optional[int] = None
    scale: Optional[int] = None
    grayscale: Optional[bool] = None
    seed: int = 1
    gpu: int = 0                  # --gpu: CUDA device index
    runs: int = 1
    neighbours: bool = False
    writeto: str = "samples"
    aws: bool = False
    dataset_dir: Optional[str] = None  # --datasetDir: store for --neighbours
    c2f: bool = False             # not ported yet: rejected by sample.py
    c2f_network: str = "adversarial_c2f_16_to_32"
    d_c2f_network: Optional[str] = None
    save_c2f: str = ""
    c2f_tries: int = 10
    mesh_shape: Tuple[int, ...] = ()  # not ported yet: must stay empty

    @property
    def channels(self) -> int:
        return 1 if self.grayscale else 3
