"""tall_declined_pct.members: the share of the traced slice's K3 calls
on the card (``k3.route.*``) that the one-model tall kernel would have
taken but that ran elsewhere because they carry a member axis
(``k3.tall_declined``), in percent."""


def read(record):
    counters = (record.get("trace") or {}).get("counters")
    if not counters or "k3.tall_declined" not in counters:
        return None
    calls = sum(n for name, n in counters.items() if name.startswith("k3.route."))
    return 100.0 * counters["k3.tall_declined"] / calls if calls else None
