"""A copy of ``repro.core.dsl``."""
from repro_torch.core.dsl.parser import parse  # noqa: F401
from repro_torch.core.dsl.compiler import compile_program, compile_source  # noqa: F401
from repro_torch.core.dsl.decompiler import decompile  # noqa: F401
from repro_torch.core.dsl.emit import emit_yaml, emit_crd, emit_helm  # noqa: F401
from repro_torch.core.dsl.validate import validate  # noqa: F401
