"""BaseNeuralField — channel-based forward dispatch (counterpart of
wisp_tpu/models/nefs/base_nef.py): subclasses register forward functions with the channels
they produce; ``forward(channels=...)`` runs the fewest functions that cover the request,
each given only the keyword arguments its signature accepts."""

from __future__ import annotations

import inspect
from typing import Dict, Iterable, List, Optional, Set, Union

from torch import nn


class BaseNeuralField(nn.Module):
    def __init__(self):
        super().__init__()
        self._forward_functions: Dict[str, tuple] = {}
        self._accepted_args: Dict[str, frozenset] = {}
        self.register_forward_functions()
        self._supported_channels: Set[str] = set()
        for _, channels in self._forward_functions.values():
            self._supported_channels |= set(channels)

    def register_forward_functions(self):
        """Subclasses call self._register_forward_function(fn, channels) here."""
        raise NotImplementedError

    def _register_forward_function(self, fn, channels: Union[str, Iterable[str]]):
        if isinstance(channels, str):
            channels = [channels]
        self._forward_functions[fn.__name__] = (fn.__name__, tuple(sorted(channels)))

    def get_supported_channels(self) -> Set[str]:
        return set(self._supported_channels)

    def _filter_call(self, fn, **kwargs):
        # the signature is read once a function: the tracers call the field in their loops
        accepted = self._accepted_args.get(fn.__name__)
        if accepted is None:
            accepted = frozenset(inspect.signature(fn).parameters)
            self._accepted_args[fn.__name__] = accepted
        return fn(**{k: v for k, v in kwargs.items() if k in accepted})

    def forward(self, channels: Optional[Union[str, List[str]]] = None, **kwargs):
        """A single tensor for a str request, else a dict {channel: tensor}."""
        if channels is None:
            requested = set(self._supported_channels)
        elif isinstance(channels, str):
            requested = {channels}
        else:
            requested = set(channels)
        unsupported = requested - self._supported_channels
        if unsupported:
            raise ValueError(f"Channels {sorted(unsupported)} are not supported by "
                             f"{type(self).__name__}; supported: "
                             f"{sorted(self._supported_channels)}")
        remaining = set(requested)
        out = {}
        for fn_name, channels_out in self._forward_functions.values():
            if not remaining & set(channels_out):
                continue
            result = self._filter_call(getattr(self, fn_name), **kwargs)
            if not isinstance(result, dict):
                (only,) = channels_out
                result = {only: result}
            for ch in requested & set(result):
                out[ch] = result[ch]
            remaining -= set(channels_out)
            if not remaining:
                break
        if isinstance(channels, str):
            return out[channels]
        return out
