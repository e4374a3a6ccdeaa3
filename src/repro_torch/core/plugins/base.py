"""Plugin framework (§5): typed transformations in a fixed pipeline order,
independently enabled and configured per decision.
A copy of ``repro.core.plugins.base``.

Request path:  fast_response -> cache -> rag -> modality -> memory ->
               system_prompt -> headers
Response path: halugate -> cache_write -> memory_write

A plugin returns either (request', None) to continue, or (request, Response)
to short-circuit (bottom symbol in Equation 13).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.types import Request, Response

REQUEST_ORDER = ("fast_response", "cache", "rag", "modality", "memory",
                 "system_prompt", "headers")
RESPONSE_ORDER = ("halugate", "cache_write", "memory_write")

PluginFn = Callable[[Request, Dict[str, Any], Dict[str, Any]],
                    Tuple[Request, Optional[Response]]]

_REGISTRY: Dict[str, PluginFn] = {}


def register_plugin(name: str, fn: PluginFn):
    _REGISTRY[name] = fn


def get_plugin(name: str) -> PluginFn:
    return _REGISTRY[name]


class PluginChain:
    """Psi_d*: the per-decision composition (Equation 14)."""

    def __init__(self, plugin_cfg: Dict[str, Dict[str, Any]],
                 context: Dict[str, Any]):
        self.cfg = plugin_cfg
        self.ctx = context

    def run_request(self, req: Request):
        trace = []
        for name in REQUEST_ORDER:
            if name not in self.cfg or not self.cfg[name].get("enabled", True):
                continue
            if name not in _REGISTRY:
                continue
            req, resp = _REGISTRY[name](req, self.ctx, self.cfg[name])
            trace.append({"plugin": name,
                          "short_circuit": resp is not None})
            if resp is not None:
                return req, resp, trace
            if self.ctx.get("cache_join_entry") is not None:
                # deferred cache join: this request rides an in-flight
                # identical query — stop the chain exactly where a cache
                # hit would have short-circuited (no rag/memory/prompt
                # work whose results would be discarded)
                return req, None, trace
        return req, None, trace

    def run_response(self, req: Request, resp: Response):
        trace = []
        for name in RESPONSE_ORDER:
            if name not in self.cfg or not self.cfg[name].get("enabled", True):
                continue
            if name not in _REGISTRY:
                continue
            _, maybe = _REGISTRY[name](req, self.ctx,
                                       dict(self.cfg[name], response=resp))
            trace.append({"plugin": name})
            if maybe is not None:
                resp = maybe
        return resp, trace
