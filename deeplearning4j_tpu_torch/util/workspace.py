"""Memory workspaces: a scoped-semantics shim over PyTorch's allocator.

The counterpart of ``deeplearning4j_tpu/util/workspace.py``, copied.
Reference: org.nd4j.linalg.api.memory.MemoryWorkspace +
Nd4j.getWorkspaceManager(). The reference needs arena allocators because
every op materialises its output buffer and the JVM GC can't keep up with
device memory churn. PyTorch's caching allocator already keeps freed
device blocks for reuse, so the optimisation the workspace API exists
for is the default here. The API is kept for source compatibility:
scopes still nest and validate, which makes porting reference code
(try-with-resources blocks) mechanical.
"""

from __future__ import annotations

import threading

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


class MemoryWorkspace:
    """Context-manager workspace scope (reference: try (MemoryWorkspace ws =
    ...getAndActivateWorkspace(id)) { ... })."""

    def __init__(self, id: str = "WS", config=None):
        self.id = id
        self.config = config
        self._entered = False

    def __enter__(self):
        _stack().append(self)
        self._entered = True
        return self

    def __exit__(self, *exc):
        st = _stack()
        if not st or st[-1] is not self:
            raise RuntimeError(f"workspace scope corruption: closing {self.id} "
                               f"but top of stack is "
                               f"{st[-1].id if st else 'empty'}")
        st.pop()
        self._entered = False
        return False

    def notifyScopeEntered(self):
        return self.__enter__()

    def notifyScopeLeft(self):
        return self.__exit__()

    def isScopeActive(self) -> bool:
        return self._entered


class WorkspaceConfiguration:
    """Accepted-and-ignored knobs (initialSize, policyAllocation...) — the
    allocator owns allocation; kept so reference configs parse."""

    def __init__(self, **kwargs):
        self.options = dict(kwargs)


class WorkspaceManager:
    """Reference: Nd4j.getWorkspaceManager()."""

    @staticmethod
    def getAndActivateWorkspace(id: str = "WS", config=None) -> MemoryWorkspace:
        ws = MemoryWorkspace(id, config)
        ws.__enter__()
        return ws

    @staticmethod
    def getCurrentWorkspace():
        st = _stack()
        return st[-1] if st else None

    @staticmethod
    def scopeOutOfWorkspaces():
        """Null scope: detached from any workspace (a no-op here)."""
        class _Null:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False
        return _Null()
