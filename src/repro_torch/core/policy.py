"""Multi-tenant policy control plane: named RouterPrograms over one
shared serving substrate, with atomic zero-downtime hot-reload.
A copy of ``repro.core.policy``; the registry compiles every policy on
its default program's device.

One process, many scenarios (the ROADMAP north-star): every policy is a
fully compiled :class:`~repro_torch.core.program.RouterProgram`; the fleet,
encoder, caches and endpoint router are shared.  Requests pick their
policy per-request via ``metadata["policy"]`` or the ``X-VSR-Policy``
header; unresolved names fall back to the default policy (counted in
``policy_unknown_total``) instead of failing the request.

Hot reload is a pointer swap: ``reload(name, dsl_text)`` validates and
compiles the new program in the CALLING thread (off the serving driver),
then swaps the registry entry under the lock.  Batches in flight keep
the program object they resolved at batch start, so a reload never
mutates state under a running pipeline and drops zero requests.

``load_policy_dir`` + :class:`PolicyWatcher` give ``serve.py
--policy-dir DIR --watch`` file-based multi-tenant config: one ``*.vsr``
DSL file per policy, edited files re-compiled and swapped live.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional

from repro_torch.core.observability import METRICS
from repro_torch.core.program import RouterProgram, compile_router_program
from repro_torch.core.types import Request

POLICY_HEADER = "x-vsr-policy"
POLICY_EXTENSIONS = (".vsr", ".dsl")


def request_policy_name(req: Request) -> Optional[str]:
    """Per-request policy selection: explicit metadata wins, then the
    X-VSR-Policy transport header (case-insensitive)."""
    name = req.metadata.get("policy")
    if name:
        return str(name)
    for k, v in req.headers.items():
        if k.lower() == POLICY_HEADER:
            return v
    return None


class PolicyRegistry:
    """Named compiled programs sharing one serving substrate."""

    def __init__(self, default: RouterProgram,
                 on_register: Optional[Callable[[RouterProgram], None]]
                 = None, lint: str = "strict"):
        self._lock = threading.Lock()
        self.default_name = default.name
        self._programs: Dict[str, RouterProgram] = {default.name: default}
        # every reload compiles its decision gate where the default's runs
        self.device = default.device
        # hook for the owning router: preload signal reference embeddings,
        # merge model profiles into the shared selection context, ...
        self._on_register = on_register
        # Level-4 lint mode applied on every reload: "strict" rejects
        # policies with fatal verifier findings (the old program keeps
        # serving), "warn" attaches findings only, "off" skips the pass
        self.lint = lint

    # -- reads ---------------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._programs)

    def get(self, name: Optional[str] = None) -> RouterProgram:
        """Resolve a program by name; None or an unknown name returns the
        default program (unknown names are counted, not failed — a tenant
        typo must not 500 the request)."""
        with self._lock:
            if name is None:
                return self._programs[self.default_name]
            prog = self._programs.get(name)
            if prog is None:
                METRICS.inc("policy_unknown_total", policy=name)
                return self._programs[self.default_name]
            return prog

    def resolve(self, req: Request) -> RouterProgram:
        return self.get(request_policy_name(req))

    # -- writes --------------------------------------------------------
    def register(self, program: RouterProgram) -> RouterProgram:
        if self._on_register is not None:
            self._on_register(program)
        with self._lock:
            self._programs[program.name] = program
        METRICS.inc("policy_reloads_total", policy=program.name)
        return program

    def reload(self, name: str, dsl_text: str) -> RouterProgram:
        """Validate + compile OUTSIDE the lock, then atomically swap the
        program pointer.  A compile error raises here and leaves the old
        program serving — zero-downtime by construction."""
        with self._lock:
            old = self._programs.get(name)
        version = old.version + 1 if old is not None else 1
        program = compile_router_program(dsl_text, name=name,
                                         version=version, lint=self.lint,
                                         device=self.device)
        return self.register(program)


def load_policy_dir(registry: PolicyRegistry, path: str) -> List[str]:
    """Load every ``*.vsr``/``*.dsl`` file in ``path`` as a named policy
    (name = file stem).  Returns the loaded names."""
    loaded = []
    for fn in sorted(os.listdir(path)):
        stem, ext = os.path.splitext(fn)
        if ext not in POLICY_EXTENSIONS:
            continue
        with open(os.path.join(path, fn)) as f:
            registry.reload(stem, f.read())
        loaded.append(stem)
    return loaded


class PolicyWatcher:
    """mtime-polling hot-reloader for a policy directory.  Compilation
    happens on the watcher thread; serving threads only ever see the
    atomic pointer swap.  A policy file that fails validation logs the
    error and keeps the previous program serving."""

    def __init__(self, registry: PolicyRegistry, path: str,
                 interval_s: float = 0.5,
                 on_error: Optional[Callable[[str, Exception], None]]
                 = None):
        self.registry = registry
        self.path = path
        self.interval_s = interval_s
        self.on_error = on_error
        self._mtimes: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="vsr-policy-watch")
        self.reloads = 0
        self._snapshot()          # baseline: don't re-compile at startup

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # ------------------------------------------------------------------
    def _snapshot(self):
        for fn in os.listdir(self.path):
            if os.path.splitext(fn)[1] in POLICY_EXTENSIONS:
                try:
                    self._mtimes[fn] = os.path.getmtime(
                        os.path.join(self.path, fn))
                except OSError:         # raced a delete/rename
                    pass

    def poll_once(self) -> List[str]:
        """One scan: reload files whose mtime changed (or are new).
        Exposed separately so tests can drive the watcher without
        sleeping.  Never raises — a file vanishing mid-scan (editor
        rename, deploy swap) or a broken policy must not kill the
        watcher thread."""
        changed = []
        for fn in sorted(os.listdir(self.path)):
            stem, ext = os.path.splitext(fn)
            if ext not in POLICY_EXTENSIONS:
                continue
            full = os.path.join(self.path, fn)
            try:
                mtime = os.path.getmtime(full)
                if self._mtimes.get(fn) == mtime:
                    continue
                self._mtimes[fn] = mtime
                with open(full) as f:
                    src = f.read()
            except OSError:             # deleted/renamed between list+stat
                self._mtimes.pop(fn, None)   # re-reload if it reappears
                continue
            try:
                self.registry.reload(stem, src)
                self.reloads += 1
                changed.append(stem)
            except Exception as e:      # bad policy: keep old one serving
                METRICS.inc("policy_reload_errors_total", policy=stem)
                if self.on_error is not None:
                    self.on_error(stem, e)
        return changed

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except OSError:             # e.g. the policy dir itself is gone
                continue
