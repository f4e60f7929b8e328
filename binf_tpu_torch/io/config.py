"""Typed run configuration (a copy of ``binf_tpu/io/config.py``, which the
port may not import).

The reference has no config system: constructor kwargs and hard-coded
experiment constants (``example_script.py:17-30``).  These dataclasses
capture a run's model-independent settings, serialise to JSON for
reproducibility, and ride inside checkpoints.  The JSON is the JAX
package's, key for key.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

__all__ = ["KernelConfig", "AdaptationConfig", "MeshConfig", "RunConfig"]


@dataclass(frozen=True)
class KernelConfig:
    """Which transition kernel, with its static hyperparameters."""

    algorithm: str = "hmc"  # rwm | mala | hmc | nuts | gibbs
    step_size: float = 0.1
    num_integration_steps: int = 10  # hmc
    max_doublings: int = 8  # nuts
    proposal: str = "uniform"  # rwm
    divergence_threshold: float = 1000.0


@dataclass(frozen=True)
class AdaptationConfig:
    num_warmup: int = 500
    target_accept: float = 0.8
    initial_step_size: float = 0.1
    adapt_mass: bool = True


@dataclass(frozen=True)
class MeshConfig:
    n_devices: int | None = None  # None = all
    host_axis: bool = False
    chain_axis_name: str = "chain"


@dataclass(frozen=True)
class RunConfig:
    n_chains: int = 1024
    num_samples: int = 1000
    thin: int = 1
    seed: int = 0
    kernel: KernelConfig = field(default_factory=KernelConfig)
    adaptation: AdaptationConfig = field(default_factory=AdaptationConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint_path: str | None = None
    checkpoint_every: int = 0  # 0 = off
    log_every: int = 100

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        d = json.loads(s)
        d["kernel"] = KernelConfig(**d.get("kernel", {}))
        d["adaptation"] = AdaptationConfig(**d.get("adaptation", {}))
        d["mesh"] = MeshConfig(**d.get("mesh", {}))
        return cls(**d)
