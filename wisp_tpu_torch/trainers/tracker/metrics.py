"""MetricsBoard — named running metrics averaged per epoch (counterpart of
wisp_tpu/trainers/tracker/metrics.py). Supports ``board.total_loss += x``."""

from __future__ import annotations

from typing import Any, Dict


class MetricsBoard:
    def __init__(self):
        object.__setattr__(self, "_metrics", {})
        object.__setattr__(self, "_counts", {})

    @property
    def active_metrics(self):
        return list(self._metrics.keys())

    def define_metric(self, name: str, aggregation_type=float) -> None:
        self._metrics[name] = aggregation_type()
        self._counts[name] = 0

    def clear(self) -> None:
        for name in self._metrics:
            self._metrics[name] = type(self._metrics[name])()
            self._counts[name] = 0

    def average_metric(self, name: str) -> float:
        count = max(self._counts.get(name, 0), 1)
        return self._metrics.get(name, 0.0) / count

    def finalize_epoch(self) -> Dict[str, float]:
        """The epoch's averages; the accumulators start again."""
        averages = {name: self.average_metric(name) for name in self._metrics}
        self.clear()
        return averages

    def state_dict(self) -> Dict[str, Any]:
        return {"metrics": dict(self._metrics), "counts": dict(self._counts)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._metrics.update(state["metrics"])
        self._counts.update(state["counts"])

    def __getattr__(self, name: str):
        metrics = object.__getattribute__(self, "_metrics")
        if name in metrics:
            return metrics[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any):
        self._metrics[name] = value
        self._counts[name] = self._counts.get(name, 0) + 1

    def __getitem__(self, name: str):
        return self._metrics[name]
