"""Domain core: jobs, rules, groups, nodes, accounts, key layout (copy of
``cronsun_tpu/core/``).

The Python analogue of the reference's root package (Job/Group/Node/Process/
JobLog/Account + etcd key helpers).  Storage-agnostic: models serialize to
JSON and live in the coordination store under the same key layout as the
reference (SURVEY.md appendix).
"""

from .errors import (  # noqa: F401
    CronsunError, NotFound, SecurityInvalid, ValidationError)
from .ids import next_id  # noqa: F401
from .keyspace import Keyspace  # noqa: F401
from .models import (  # noqa: F401
    Account, DepSpec, Group, Job, JobRule, KIND_ALONE, KIND_COMMON,
    KIND_INTERVAL, MAX_DEPS, MISFIRE_POLICIES, Node, ROLE_ADMIN,
    ROLE_DEVELOPER, TenantQuota, validate_dag)
