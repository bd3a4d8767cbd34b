"""The Maelstrom error registry.

A copy of the registry half of `maelstrom_tpu/errors.py`: the runner
reads an error reply's code here to complete the op as a definite
`fail` or an indefinite `info`.

Mirrors the behavior of the reference's error system
(`src/maelstrom/client.clj:19-100`): errors have an integer code, a friendly
name, a docstring, and a `definite` flag. A *definite* error means the
requested operation definitely did not happen; indefinite errors leave the
outcome unknown. The registry drives both client-side error interpretation
(`with_errors`) and documentation generation (doc/protocol.md).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ErrorDef:
    code: int
    name: str
    doc: str
    definite: bool = False


# code -> ErrorDef  (reference `client.clj:19-27`)
ERROR_REGISTRY: dict[int, ErrorDef] = {}


class DuplicateError(Exception):
    pass


def deferror(code: int, name: str, doc: str,
             definite: bool = False) -> ErrorDef:
    """Defines a new type of error and registers it, checking for duplicate
    codes and names (reference `client.clj:29-55`)."""
    if code in ERROR_REGISTRY:
        # Idempotent re-registration (module reloads) is fine if identical.
        extant = ERROR_REGISTRY[code]
        if extant.name == name and extant.doc == doc:
            return extant
        raise DuplicateError(f"duplicate error code {code}: {extant}")
    for e in ERROR_REGISTRY.values():
        if e.name == name:
            raise DuplicateError(f"duplicate error name {name}: {e}")
    err = ErrorDef(code=code, name=name, doc=doc, definite=definite)
    ERROR_REGISTRY[code] = err
    return err


# --- Standard errors (reference `client.clj:57-100`) ---

TIMEOUT = deferror(
    0, "timeout",
    "Indicates that the requested operation could not be completed within a "
    "timeout.")

NODE_NOT_FOUND = deferror(
    1, "node-not-found",
    "Thrown when a client sends an RPC request to a node which does not "
    "exist.",
    definite=True)

NOT_SUPPORTED = deferror(
    10, "not-supported",
    "Use this error to indicate that a requested operation is not supported "
    "by the current implementation. Helpful for stubbing out APIs during "
    "development.",
    definite=True)

TEMPORARILY_UNAVAILABLE = deferror(
    11, "temporarily-unavailable",
    "Indicates that the operation definitely cannot be performed at this "
    "time--perhaps because the server is in a read-only state, has not yet "
    "been initialized, believes its peers to be down, and so on. Do *not* "
    "use this error for indeterminate cases, when the operation may actually "
    "have taken place.",
    definite=True)

MALFORMED_REQUEST = deferror(
    12, "malformed-request",
    "The client's request did not conform to the server's expectations, and "
    "could not possibly have been processed.",
    definite=True)

CRASH = deferror(
    13, "crash",
    "Indicates that some kind of general, indefinite error occurred. Use "
    "this as a catch-all for errors you can't otherwise categorize, or as a "
    "starting point for your error handler: it's safe to return "
    "`internal-error` for every problem by default, then add special cases "
    "for more specific errors later.",
    definite=False)

ABORT = deferror(
    14, "abort",
    "Indicates that some kind of general, definite error occurred. Use this "
    "as a catch-all for errors you can't otherwise categorize, when you "
    "specifically know that the requested operation has not taken place. "
    "For instance, you might encounter an indefinite failure during the "
    "prepare phase of a transaction: since you haven't started the commit "
    "process yet, the transaction can't have taken place. It's therefore "
    "safe to return a definite `abort` to the client.",
    definite=True)


NOT_LEADER = deferror(
    31, "not-leader",
    "The contacted node is not the cluster's current leader, so the "
    "operation definitely did not execute. The error body may carry a "
    "`hint` naming the node the sender believes leads (-1 when no live "
    "leader is known, e.g. mid-election); clients should retry against "
    "the hint under backoff (doc/compartment.md 'leader election').",
    definite=True)


BYZANTINE = deferror(
    32, "byzantine",
    "The receiver detected Byzantine (lying) behavior in this message — "
    "an equivocating assignment, a ballot outside the sender's residue "
    "class, or a forged expansion proof — and definitely did not act on "
    "it. The rejection is also booked as conviction evidence for the "
    "`byzantine` results block (doc/faults.md 'byzantine is a "
    "conviction driver').",
    definite=True)
