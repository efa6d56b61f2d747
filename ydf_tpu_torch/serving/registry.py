"""Ranked serving-engine registry (counterpart of
ydf_tpu/serving/registry.py: EngineFactory / register_engine /
compatible_engines / best_engine).

Every engine declares a compatibility check and a rank; a model serves
through the highest-ranked compatible engine unless one is forced by
name. The ranks follow the H100's own order: chip_smoke.py times both
CUDA engines on the default GBT (gbt_d6, 300 trees of depth 6) at
1,048,576 rows and fails if the registry does not pick the faster one
when one is more than 10% faster (PERF.md has the times). Since the bank
kernel's redesign the bank is the faster, so its rank is above
QuickScorer's, the reverse of the JAX package's TPU ranking; both add
the same leaf values in the same order, so the scores do not change:

  BankScorer   300  data-bank CUDA kernel, any tree shape (the JAX
                    package's PallasBank; renamed, it is not Pallas here)
  QuickScorer  250  leaf-bitmask CUDA kernel, trees of <= 64 leaves
                    whose tree blocks fit its shared memory
  Routed         0  generic routed scan in plain PyTorch (ops/routing.py);
                    the only engine for a model with vector-sequence
                    features (the other two refuse it, as the JAX
                    package's QuickScorer and PallasBank do) and for a
                    random forest (its predict takes the mean of the
                    trees, which the JAX package also serves routed)

The CPU-only NativeBatch engine, the request-coalescing batcher and the
serving env knobs are not ported (ROADMAP Queue 1 item 19).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from ydf_tpu_torch.serving import bank_scorer, quickscorer


@dataclasses.dataclass(frozen=True)
class EngineFactory:
    """One serving engine: higher rank = preferred when compatible."""

    name: str
    rank: int
    is_compatible: Callable[[object], bool]
    build: Callable[[object], object]  # model -> engine, or None (Routed)


_REGISTRY: List[EngineFactory] = []


def register_engine(factory: EngineFactory) -> None:
    _REGISTRY.append(factory)
    _REGISTRY.sort(key=lambda f: -f.rank)


def compatible_engines(model) -> List[EngineFactory]:
    """Compatible factories, highest rank first."""
    return [f for f in _REGISTRY if f.is_compatible(model)]


def best_engine(model, forced: Optional[str] = None) -> EngineFactory:
    if forced is not None:
        for f in _REGISTRY:
            if f.name == forced:
                if not f.is_compatible(model):
                    raise ValueError(
                        f"Engine {forced!r} is not compatible with this "
                        f"model (compatible: "
                        f"{[c.name for c in compatible_engines(model)]})"
                    )
                _note_selected(f, forced=True)
                return f
        raise ValueError(
            f"Unknown engine {forced!r}; registered: "
            f"{[f.name for f in _REGISTRY]}"
        )
    compat = compatible_engines(model)
    if not compat:
        raise RuntimeError("No compatible serving engine (missing Routed?)")
    _note_selected(compat[0], forced=False)
    return compat[0]


def _note_selected(factory: EngineFactory, forced: bool) -> None:
    """Counts the selection in ydf_serve_engine_selected_total (engine,
    forced) when telemetry is on."""
    from ydf_tpu_torch.utils import telemetry

    if telemetry.ENABLED:
        telemetry.counter("ydf_serve_engine_selected_total",
                          engine=factory.name,
                          forced=str(forced).lower()).inc()


def _qs_compatible(model) -> bool:
    if not bank_scorer.in_envelope(model):
        return False
    qsm = quickscorer.compile_forest_cached(
        model.forest, model.binner.num_numerical,
        num_features=model.binner.num_scalar,
    )
    return qsm is not None and quickscorer.fits_shared_memory(qsm)


register_engine(EngineFactory(
    name="QuickScorer",  # csrc/quickscorer.cu
    rank=250,
    is_compatible=_qs_compatible,
    build=quickscorer.build_quickscorer,
))

register_engine(EngineFactory(
    name="BankScorer",  # csrc/bank_scorer.cu
    rank=300,
    is_compatible=bank_scorer.in_envelope,
    build=bank_scorer.build_bank_scorer,
))

register_engine(EngineFactory(
    name="Routed",  # ops/routing.py; GenericModel._raw_scores runs it
    rank=0,
    is_compatible=lambda model: True,
    build=lambda model: None,
))
