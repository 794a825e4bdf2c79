"""Web/API server: the management control surface.

The same /v1 REST semantics as the reference's gorilla/mux router
(web/routers.go:17-114) on the stdlib ThreadingHTTPServer — session auth
backed by the coordination store, role-gated admin endpoints, job/group
CRUD writing the same keyspace the scheduler watches, log queries against
the result store, and a single-file management UI at /ui/.

Copy of ``cronsun_tpu/web/__init__.py``.
"""

from .server import ApiServer  # noqa: F401
from .sessions import SessionStore  # noqa: F401
