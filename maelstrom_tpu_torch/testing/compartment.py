"""Seeded hazard inputs of the compartment's role steps, shared by the
CPU parity tests, the card's kernel tests (`tests/test_torch_kernels_gpu.py`)
and the chip smoke's `election_kernels` phase: numpy fields of an inbox
and a state that exercise every lane type the role reads and the parity
hazards of K23-K29. `random_compartment_inputs` is the entry point; it
hands an elected tier (S > 1) to `random_elect_inputs`.
`random_byz_inputs` gives the same under the byzantine adversary: the
proxies' evidence leaves and conflicting, stale and honest assigns, and
the E_BYZANTINE NACKs that reach the sequencers."""

from __future__ import annotations

import numpy as np

INT32_MAX = 2**31 - 1


def random_compartment_inputs(rng, role, lay, n, rnd):
    """(inbox, state) as numpy fields for a compartment role step at
    round `rnd`: every lane type the role reads and some it does not,
    slots repeated across lanes, matching live rows and past the log's
    capacity, grid and replica indices past both ends, words at INT32_MAX
    (b + 1 wraps and clips to 0), client ids below and above the
    cluster, tables empty, partly full and full, rows due and not due,
    acks one short of a quorum, logs whose apply frontier is stored or
    missing, commands of every op with keys past the row. With an
    elected tier (S > 1) the elected steps' inputs
    (`random_elect_inputs`)."""
    if lay.S > 1:
        return random_elect_inputs(rng, role, lay, n, rnd)
    K_, C = lay.K, lay.cap
    shape = (n, K_)
    Q = {"sequencers": lay.QL, "proxies": lay.QP}.get(role, 1)

    def ri(lo, hi, shp):
        return rng.integers(lo, hi, shp).astype(np.int32)

    def dens(shp):
        # per-node fill: empty, sparse, half, dense, full
        d = rng.choice(np.array([0.0, 0.1, 0.5, 0.9, 1.0]), (shp[0], 1))
        return rng.random(shp) < d
    last = rnd - ri(0, 2 * lay.retry, (n, Q))
    last[rng.random((n, Q)) < 0.2] = -(1 << 20)
    inbox = {"valid": rng.random(shape) < 0.85,
             "src": ri(0, lay.n_nodes + 40, shape),
             "dest": ri(0, n, shape), "due": ri(0, 50, shape),
             "mid": ri(0, 1000, shape),
             "reply_to": ri(-1, 1000, shape),
             "b": ri(-2, 9, shape), "c": ri(-2, 9, shape)}
    for w in ("b", "c"):
        inbox[w][rng.random(shape) < 0.04] = INT32_MAX
    if role == "sequencers":
        slots = ri(0, C + 4, (n, Q))
        types = np.array([10, 12, 14, 35, 35, 30, 0, 31], np.int32)
        a = ri(-2, 8, shape)
        a[rng.random(shape) < 0.05] = lay.keys + 3
        done = rng.random(shape) < 0.5
        pick = slots[np.arange(n)[:, None], ri(0, Q, shape)]
        inbox["type"] = rng.choice(types, shape).astype(np.int32)
        inbox["a"] = np.where(inbox["type"] == 35,
                              np.where(done, pick, ri(0, C + 4, shape)),
                              a).astype(np.int32)
        nxt = ri(0, C + 1, (n,))
        nxt[rng.random(n) < 0.3] = C - rng.integers(0, 3)
        state = {"next_slot": nxt, "t_valid": dens((n, Q)),
                 "t_slot": slots, "t_cmd": ri(0, 1 << 30, (n, Q)),
                 "t_client": ri(0, 0x8000, (n, Q)),
                 "t_mid": ri(-1, 1000, (n, Q)), "t_last": last}
    elif role == "proxies":
        AR = lay.AR
        slots = ri(0, C + 4, (n, Q))
        pick = slots[np.arange(n)[:, None], ri(0, Q, shape)]
        types = np.array([32, 32, 34, 34, 30, 30, 0, 35], np.int32)
        inbox["type"] = rng.choice(types, shape).astype(np.int32)
        slot_in = np.where(rng.random(shape) < 0.6, pick,
                           ri(0, C + 4, shape)) & 0x7FFF
        client = ri(0, 0x8000, shape)
        inbox["a"] = np.where(inbox["type"] == 30,
                              (client << 16) | slot_in,
                              slot_in).astype(np.int32)
        inbox["b"] = np.where(np.isin(inbox["type"], (32, 34)),
                              ri(-1, AR + 2, shape),
                              inbox["b"]).astype(np.int32)
        acks = rng.random((n, Q, AR)) < rng.choice(
            np.array([0.0, 0.5, 0.8, 1.0]), (n, Q, 1))
        state = {"p_valid": dens((n, Q)), "p_learn": rng.random((n, Q)) < 0.4,
                 "p_slot": slots, "p_cmd": ri(0, 1 << 30, (n, Q)),
                 "p_client": ri(0, 0x8000, (n, Q)),
                 "p_mid": ri(-1, 1000, (n, Q)), "p_last": last,
                 "p_acks": acks}
    elif role == "acceptors":
        types = np.array([31, 31, 31, 32, 0, 33], np.int32)
        inbox["type"] = rng.choice(types, shape).astype(np.int32)
        a = ri(-2, C + 3, shape)
        rep = rng.random(shape) < 0.3
        a[rep] = a[np.nonzero(rep)[0], 0]            # repeated slots
        inbox["a"] = a
        state = {"acc_cmd": ri(0, 1 << 30, (n, C)),
                 "acc_has": rng.random((n, C)) < 0.3}
    else:
        keys = lay.keys
        applied = ri(-1, C, (n,))
        applied[rng.random(n) < 0.2] = C - 1 - rng.integers(0, 3)
        applied[0] = -1
        base = applied[:, None] + ri(-2, lay.AP + 3, shape)
        slot_in = np.where(rng.random(shape) < 0.1, C + ri(0, 3, shape),
                           base) & 0x7FFF
        rep = rng.random(shape) < 0.2
        slot_in[rep] = slot_in[np.nonzero(rep)[0], 0]
        client = ri(0, 0x8000, shape)
        types = np.array([33, 33, 33, 34, 0, 31], np.int32)
        inbox["type"] = rng.choice(types, shape).astype(np.int32)
        inbox["a"] = ((client << 16) | slot_in).astype(np.int32)
        key = ri(0, keys, (n, C))
        key[rng.random((n, C)) < 0.02] = min(keys + 1, 4095)
        op = ri(0, 4, (n, C))
        v1, v2 = ri(0, 10, (n, C)), ri(0, 10, (n, C))
        cmd = (key << 18) | (op << 16) | (v1 << 8) | v2
        inbox["b"] = np.where(inbox["type"] == 33,
                              cmd[np.arange(n)[:, None],
                                  ri(0, C, shape)], inbox["b"]
                              ).astype(np.int32)
        has = rng.random((n, C)) < 0.3
        # runs of stored slots past the frontier
        for r in range(n):
            lo = max(applied[r] + 1, 0)
            has[r, lo:lo + rng.integers(0, 2 * lay.AP)] = True
        state = {"r_cmd": cmd.astype(np.int32),
                 "r_client": ri(0, 0x8000, (n, C)),
                 "r_mid": ri(-2, 1000, (n, C)), "r_has": has,
                 "applied": applied, "kv": ri(0, 10, (n, keys))}
    return inbox, state




def random_elect_inputs(rng, role, lay, n, rnd):
    """(inbox, state) as numpy fields for an elected compartment role
    step (S > 1) at round `rnd`: every phase-1 lane type beside the
    phase-2 ones; ties on the T_QVAL ballot across lanes, duplicate and
    stale prepares, T_P2A below, at and above the promise, T_QRY of a
    slot a T_P2A writes in the same round, done_bits backlogs past the
    8-step frontier advance, ballots at the ballot-width limit, leading,
    electing and idle candidates with deadlines and backoffs on either
    side of the round (one parked at INT32_MAX), higher-ballot assigns
    over stale proxy rows and stale ones over fresh rows, P2B acks that
    echo the row's ballot and ones that do not, learns from clients
    whose ids are not multiples of 8."""
    K_, C, A, S = lay.K, lay.cap, lay.A, lay.S
    shape = (n, K_)
    top = 1 << lay.bal_width
    Q = {"sequencers": lay.QL, "proxies": lay.QP}.get(role, 1)

    def ri(lo, hi, shp):
        return rng.integers(lo, hi, shp).astype(np.int32)

    def pick(rows):
        return rows[np.arange(n)[:, None], ri(0, rows.shape[1], shape)]

    def choose(codes):
        return rng.choice(np.array(codes, np.int32), shape).astype(np.int32)
    last = rnd - ri(0, 2 * lay.retry, (n, Q))
    last[rng.random((n, Q)) < 0.2] = -(1 << 20)
    inbox = {"valid": rng.random(shape) < 0.85,
             "src": ri(0, lay.n_nodes + 40, shape),
             "dest": ri(0, n, shape), "due": ri(0, 50, shape),
             "mid": ri(0, 1000, shape), "reply_to": ri(-1, 1000, shape),
             "b": ri(-2, 9, shape), "c": ri(-2, 9, shape)}
    if role == "sequencers":
        bal = ri(0, top, (n,))
        bal[rng.random(n) < 0.3] = top - 1 - rng.integers(0, S)
        seen = np.maximum(bal - ri(-3, 4, (n,)), 0).astype(np.int32)
        slots = ri(0, C + 4, (n, Q))
        dfront = ri(-1, C, (n,))
        done_bits = rng.random((n, C)) < 0.2
        for r in range(n):
            # a backlog past the 8-step advance, and one with a hole
            lo = dfront[r] + 1
            done_bits[r, lo:lo + rng.integers(0, 20)] = True
        tq = rng.random((n, Q)) < 0.5
        state = {
            "next_slot": ri(0, C + 1, (n,)),
            "t_valid": rng.random((n, Q)) < rng.choice(
                np.array([0.0, 0.5, 0.9, 1.0]), (n, 1)),
            "t_slot": slots, "t_cmd": ri(0, 1 << 30, (n, Q)),
            "t_client": ri(0, 0x1000, (n, Q)),
            "t_mid": ri(-1, 1000, (n, Q)), "t_last": last,
            "bal": bal, "seen": seen,
            "leading": rng.random(n) < 0.4,
            "electing": rng.random(n) < 0.4,
            "prom": ri(0, 1 << A, (n,)),
            "cand_round": rnd - ri(0, 100, (n,)),
            "rec_hi": ri(-1, C + 2, (n,)), "rec_next": ri(0, C, (n,)),
            "heard": rnd - ri(0, 2 * lay.etimeout, (n,)),
            "deadline": rnd + ri(-20, 20, (n,)),
            "boff": rnd + ri(-20, 20, (n,)),
            "hb_last": rnd - ri(0, 2 * lay.retry, (n,)),
            "elect_last": rnd - ri(0, 2 * lay.retry, (n,)),
            "t_bal": ri(0, top, (n, Q)), "t_q": tq,
            "t_qmask": ri(0, 1 << A, (n, Q)),
            "t_qbal": ri(-1, top, (n, Q)),
            "done_bits": done_bits, "dfront": dfront,
            "won_count": ri(0, 5, (n,)), "won_sum": ri(0, 500, (n,)),
            "won_max": ri(0, 200, (n,)), "bal_overflow": ri(0, 3, (n,))}
        state["deadline"][rng.random(n) < 0.1] = 0x7FFFFFFF
        state["elect_last"][rng.random(n) < 0.2] = -(1 << 20)
        types = choose([10, 12, 14, 35, 35, 37, 37, 38, 41, 41, 41, 42,
                        43, 0, 31])
        inbox["type"] = types
        a = ri(-2, 8, shape)
        a = np.where(types == 35, np.where(
            rng.random(shape) < 0.5, pick(slots),
            dfront[:, None] + ri(1, 12, shape)), a)
        a = np.where((types == 37) | (types == 38), np.where(
            rng.random(shape) < 0.7, bal[:, None], ri(0, top, shape)), a)
        a = np.where(types == 41, pick(slots), a)
        a = np.where((types == 42) | (types == 43),
                     seen[:, None] + ri(-2, 3, shape), a)
        inbox["a"] = a.astype(np.int32)
        qbal = ri(0, 3, (n, 1)) * 5 - 1      # the lanes' tied ballot
        inbox["b"] = np.where(types == 37, ri(-1, A + 2, shape),
                              np.where(types == 41,
                                       ri(0, 1 << 30, shape),
                                       inbox["b"])).astype(np.int32)
        prom_c = (ri(0, C + 1, shape) << 13) | ri(0, C + 1, shape)
        qval_c = (ri(-1, A + 2, shape) << 16) | np.where(
            rng.random(shape) < 0.6, qbal + 1, ri(0, top, shape))
        inbox["c"] = np.where(types == 37, prom_c, np.where(
            types == 38, ri(0, top, shape), np.where(
                types == 41, qval_c, inbox["c"]))).astype(np.int32)
    elif role == "proxies":
        AR = lay.AR
        slots = ri(0, C + 4, (n, Q)) & 0xFFF
        p_bal = ri(0, top, (n, Q))
        types = choose([32, 32, 34, 34, 30, 30, 30, 39, 39, 0, 35])
        inbox["type"] = types
        slot_in = np.where(rng.random(shape) < 0.6, pick(slots),
                           ri(0, C + 4, shape)) & 0xFFF
        bal_in = np.where(rng.random(shape) < 0.5, pick(p_bal)
                          + ri(-1, 2, shape), ri(0, top, shape)) & 0x3F
        client = ri(0, 0x1000, shape)
        inbox["a"] = np.where(types == 30,
                              (bal_in << 24) | (client << 12) | slot_in,
                              slot_in).astype(np.int32)
        inbox["b"] = np.where(np.isin(types, (32, 34, 39)),
                              ri(-1, AR + 2, shape),
                              inbox["b"]).astype(np.int32)
        inbox["c"] = np.where(np.isin(types, (32, 39)), np.where(
            rng.random(shape) < 0.6, pick(p_bal) + ri(0, 2, shape),
            ri(0, top, shape)), inbox["c"]).astype(np.int32)
        acks = rng.random((n, Q, AR)) < rng.choice(
            np.array([0.0, 0.5, 0.8, 1.0]), (n, Q, 1))
        state = {"p_valid": rng.random((n, Q)) < rng.choice(
                     np.array([0.0, 0.5, 0.9, 1.0]), (n, 1)),
                 "p_learn": rng.random((n, Q)) < 0.4,
                 "p_slot": slots, "p_cmd": ri(0, 1 << 30, (n, Q)),
                 "p_client": ri(0, 0x1000, (n, Q)),
                 "p_mid": ri(-1, 1000, (n, Q)), "p_last": last,
                 "p_acks": acks, "p_bal": p_bal}
    elif role == "acceptors":
        promised = ri(0, top, (n,))
        types = choose([31, 31, 31, 36, 36, 40, 40, 44, 0, 32])
        inbox["type"] = types
        a = ri(-2, C + 3, shape)
        rep = rng.random(shape) < 0.3
        a[rep] = a[np.nonzero(rep)[0], 0]            # repeated slots
        ballots = np.where(rng.random(shape) < 0.3, promised[:, None],
                           promised[:, None] + ri(-3, 4, shape))
        # prepares: duplicates, stale ones and the round's highest
        a = np.where(types == 36, ballots, a)
        # a query of a slot a T_P2A lane writes this round
        p2a_slot = a[np.arange(n), np.argmax(types == 31, axis=1)]
        a = np.where((types == 40) & (rng.random(shape) < 0.5),
                     p2a_slot[:, None], a)
        inbox["a"] = a.astype(np.int32)
        inbox["c"] = np.where(types == 31, ballots,
                              inbox["c"]).astype(np.int32)
        inbox["b"] = np.where(types == 31, ri(0, 1 << 30, shape),
                              inbox["b"]).astype(np.int32)
        state = {"acc_cmd": ri(0, 1 << 30, (n, C)),
                 "acc_has": rng.random((n, C)) < 0.3,
                 "promised": promised,
                 "acc_bal": ri(0, top, (n, C)),
                 "acc_hi": ri(-1, C, (n,)), "acc_cmt": ri(-1, C, (n,))}
    else:
        inbox, state = _elect_replica_inputs(rng, lay, n, inbox, ri)
    return inbox, state


def _elect_replica_inputs(rng, lay, n, inbox, ri):
    """The replica's inputs with the elected learn word client<<12 |
    slot: clients of every residue mod 8 (the ones the one-sequencer
    layout would misread), slots past the frontier and the log."""
    K_, C, keys = lay.K, lay.cap, lay.keys
    shape = (n, K_)
    applied = ri(-1, C, (n,))
    applied[0] = -1
    slot_in = np.where(rng.random(shape) < 0.1, C + ri(0, 3, shape),
                       applied[:, None] + ri(-2, lay.AP + 3, shape)) & 0xFFF
    client = ri(1, 0x1000, shape)
    types = rng.choice(np.array([33, 33, 33, 34, 0, 31], np.int32), shape)
    inbox["type"] = types.astype(np.int32)
    inbox["a"] = ((client << 12) | slot_in).astype(np.int32)
    key = ri(0, keys, (n, C))
    op = ri(0, 4, (n, C))
    cmd = (key << 18) | (op << 16) | (ri(0, 10, (n, C)) << 8) | ri(
        0, 10, (n, C))
    inbox["b"] = np.where(types == 33, cmd[np.arange(n)[:, None],
                                           ri(0, C, shape)],
                          inbox["b"]).astype(np.int32)
    has = rng.random((n, C)) < 0.3
    for r in range(n):
        lo = max(applied[r] + 1, 0)
        has[r, lo:lo + rng.integers(0, 2 * lay.AP)] = True
    state = {"r_cmd": cmd.astype(np.int32),
             "r_client": ri(0, 0x1000, (n, C)),
             "r_mid": ri(-2, 1000, (n, C)), "r_has": has,
             "applied": applied, "kv": ri(0, 10, (n, keys))}
    return inbox, state


Z_KEYS = ("z_eq", "z_sb", "z_eq_src", "z_eq_slot", "z_eq_rnd", "z_sb_src",
          "z_sb_bal", "z_sb_rnd")


def random_byz_inputs(rng, role, lay, n, rnd):
    """(inbox, state) as `random_compartment_inputs` gives them, under the
    byzantine adversary. Proxies: the evidence leaves (counts 0 and not,
    witnesses and stamps unset and set), and T_ASSIGN lanes rewritten as
    equivocations (a live row's slot, with S > 1 its ballot, another
    command), honest resends (the row's command), assigns at a ballot
    beside the row's, and sources in and out of the ballot's residue
    class. Sequencers: T_ERR / E_BYZANTINE NACK lanes, which no branch of
    their step reads. The other roles as without the adversary."""
    inbox, state = random_compartment_inputs(rng, role, lay, n, rnd)
    shape = inbox["type"].shape
    if role == "sequencers":
        nack = rng.random(shape) < 0.25
        inbox["type"] = np.where(nack, 1, inbox["type"]).astype(np.int32)
        inbox["a"] = np.where(nack, 32, inbox["a"]).astype(np.int32)
        return inbox, state
    if role != "proxies":
        return inbox, state
    S, Q = lay.S, lay.QP
    rows = np.arange(n)[:, None]
    q = rng.integers(0, Q, shape)
    row_slot, row_cmd = state["p_slot"][rows, q], state["p_cmd"][rows, q]
    asg = inbox["type"] == 30
    kind = rng.integers(0, 4, shape)    # 0 conflict, 1 resend, 2/3 as drawn
    cmd = np.where(kind == 0, row_cmd ^ (1 << 8), np.where(
        kind == 1, row_cmd, inbox["b"]))
    inbox["b"] = np.where(asg, cmd, inbox["b"]).astype(np.int32)
    if S > 1:
        row_bal = state["p_bal"][rows, q]
        bal = np.where(kind < 2, row_bal, np.where(
            kind == 2, row_bal + 1, rng.integers(0, 1 << lay.bal_width,
                                                 shape))) & 0x3F
        client = (inbox["a"] >> 12) & 0xFFF
        slot = np.where(kind < 3, row_slot, inbox["a"]) & 0xFFF
        a = (bal << 24) | (client << 12) | slot
        # honest sources (bal % S), and liars outside the residue class
        src = np.where(rng.random(shape) < 0.7, bal % S,
                       rng.integers(0, lay.n_nodes, shape))
        inbox["src"] = np.where(asg, src, inbox["src"]).astype(np.int32)
    else:
        client = (inbox["a"] >> 16) & 0x7FFF
        slot = np.where(kind < 3, row_slot, inbox["a"]) & 0x7FFF
        a = (client << 16) | slot
    inbox["a"] = np.where(asg, a, inbox["a"]).astype(np.int32)

    def ri(lo, hi):
        return rng.integers(lo, hi, (n,)).astype(np.int32)
    fresh = rng.random(n) < 0.5        # no conviction yet
    for k in ("z_eq", "z_sb"):
        state[k] = np.where(fresh, 0, ri(1, 1 << 20)).astype(np.int32)
    for k in Z_KEYS[2:]:
        state[k] = np.where(fresh, -1, ri(0, 4096)).astype(np.int32)
    state["z_eq"][rng.random(n) < 0.1] = INT32_MAX     # the count wraps
    return inbox, state
