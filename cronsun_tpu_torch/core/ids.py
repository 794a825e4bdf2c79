"""Short unique ids for jobs/rules/groups (reference id.go:16-19 uses
4-byte fastuuid hex; uuid4-derived 8-hex here — same width, same shape)."""

import uuid


def next_id() -> str:
    return uuid.uuid4().hex[:8]
