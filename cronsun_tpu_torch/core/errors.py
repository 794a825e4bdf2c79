"""Sentinel errors (reference: errors.go:5-20)."""


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
