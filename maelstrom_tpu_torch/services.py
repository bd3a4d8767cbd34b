"""The pure KV state machine the ordered lin-kv applier runs.

A copy of `PersistentKV` from `maelstrom_tpu/services.py` (reference
`service.clj:31-56`): an immutable read/write/cas machine with
create_if_not_exists. The JAX package also wraps it, with LWWKV and the
TSO, in consistency adapters as host services, which the port does not
run (no host network); its in-cluster services are the role programs
of `nodes/services.py`."""

from __future__ import annotations


def error_body(code: int, text: str = "", **extra) -> dict:
    """A protocol error body (the JAX package's `errors.error_body`)."""
    body = {"type": "error", "code": code, "text": text}
    body.update(extra)
    return body


class PersistentKV:
    """Immutable KV state machine (reference `service.clj:31-56`)."""

    def __init__(self, m: dict | None = None):
        self.m = m if m is not None else {}

    def handle(self, message):
        body = message.body
        k = body.get("key")
        t = body["type"]
        if t == "read":
            if k in self.m:
                return self, {"type": "read_ok", "value": self.m[k]}
            return self, error_body(20, "key does not exist")
        if t == "write":
            return (PersistentKV({**self.m, k: body.get("value")}),
                    {"type": "write_ok"})
        if t == "cas":
            if k in self.m:
                if body.get("from") == self.m[k]:
                    return (PersistentKV({**self.m, k: body.get("to")}),
                            {"type": "cas_ok"})
                return self, error_body(
                    22, f"current value {self.m[k]!r} is not "
                        f"{body.get('from')!r}")
            if body.get("create_if_not_exists"):
                return (PersistentKV({**self.m, k: body.get("to")}),
                        {"type": "cas_ok"})
            return self, error_body(20, "key does not exist")
        return self, error_body(10, f"unsupported op {t!r}")

    def __eq__(self, other):
        return isinstance(other, PersistentKV) and self.m == other.m
