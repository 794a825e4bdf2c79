"""Sentinel errors (reference: errors.go:5-20), and :func:`is_error`."""


class CronsunError(Exception):
    pass


class NotFound(CronsunError):
    pass


class ValidationError(CronsunError):
    pass


class SecurityInvalid(ValidationError):
    """Command/user rejected by the security policy (reference
    job.go:633-656)."""


class DuplicateNode(CronsunError):
    """A live agent with this node identity is already registered
    (reference node.go:51-79: PID signal-0 probe on register)."""


def is_error(e: BaseException, *classes: type) -> bool:
    """``e`` is one of ``classes``: by class, or by class name along its
    MRO — a store or sink of the JAX package raises its own classes of
    the same names (the wire protocol names them the same way,
    ``store/remote.py``)."""
    names = {c.__name__ for c in classes}
    return isinstance(e, classes) or any(
        t.__name__ in names for t in type(e).__mro__)
