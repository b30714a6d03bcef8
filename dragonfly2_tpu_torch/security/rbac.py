"""Table-driven RBAC (the manager's casbin-policy equivalent,
manager/permission/rbac.go): role → {resource: allowed actions}. Three
built-in roles matching the reference's admin/standard split, extensible at
runtime via add_policy. The port of dragonfly2_tpu/security/rbac.py, the
same roles and answers."""

from __future__ import annotations

from typing import Iterable

READ = "read"
WRITE = "write"

# resource groups mirror the manager REST surface
_RESOURCES = (
    "scheduler-clusters", "schedulers", "seed-peers", "applications",
    "configs", "models", "jobs", "users", "certificates", "oauth", "buckets",
)

ROLES: dict[str, dict[str, set[str]]] = {
    "admin": {r: {READ, WRITE} for r in _RESOURCES},
    "operator": {
        **{r: {READ, WRITE} for r in ("applications", "configs", "models", "jobs", "buckets")},
        **{r: {READ} for r in ("scheduler-clusters", "schedulers", "seed-peers")},
    },
    "guest": {
        r: {READ}
        for r in _RESOURCES
        if r not in ("users", "certificates", "oauth")
    },
}


class Rbac:
    def __init__(self, roles: dict[str, dict[str, set[str]]] | None = None):
        self._roles = {
            role: {res: set(actions) for res, actions in perms.items()}
            for role, perms in (roles or ROLES).items()
        }

    def add_policy(self, role: str, resource: str, actions: Iterable[str]) -> None:
        self._roles.setdefault(role, {}).setdefault(resource, set()).update(actions)

    def allowed(self, role: str, resource: str, action: str) -> bool:
        return action in self._roles.get(role, {}).get(resource, set())

    @staticmethod
    def action_for_method(http_method: str) -> str:
        return READ if http_method.upper() in ("GET", "HEAD", "OPTIONS") else WRITE
