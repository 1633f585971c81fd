"""Shared by the ``test_torch_dryrun_hlo_<family>.py`` gates: the port's
per-device collective count (``roofline.train_collectives`` plus the terms
``roofline.hlo_terms`` names) held to the reference's compiled HLO by
``tools/torch_hlo_compare.py`` (its reference compiled in a process of
its own on forced CPU devices, the port counted on meta tensors)."""
import importlib.util
import os

from repro_torch.launch import roofline

TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "torch_hlo_compare.py")


def tool():
    spec = importlib.util.spec_from_file_location("torch_hlo_compare", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare(argv):
    """(the reference's {fsdp: {kind: bytes}}, the port's {fsdp: report})
    at the tool's shape for ``argv``."""
    mod = tool()
    args = mod.parser().parse_args(argv)
    return mod.run_reference(args)["bytes"], mod.port(args)


def hold(ref, mine, terms_wanted, port_only_wanted):
    """Every kind of the HLO matched within 2% or, under 1% of its total,
    listed; the named terms are ``terms_wanted`` and each one over 2% of
    its kind's HLO bytes and 1% of their total is needed (without it a
    kind differs); the
    port's own gathers are ``port_only_wanted``.  Returns the match."""
    assert set(mine["terms"]) == terms_wanted
    match = roofline.hlo_match(ref, mine["per_device"], mine["terms"])
    total = sum(ref.values())
    for kind, m in match.items():
        assert m["status"] != "differs", (kind, m)
        if m["status"] == "matched":
            assert abs(m["sum"] - m["hlo"]) <= 0.02 * m["hlo"], kind
        else:
            assert max(m["hlo"], m["sum"]) < 0.01 * total, kind
    for name, term in mine["terms"].items():
        if not any(abs(v) > max(0.02 * ref.get(k, 0.0), 0.01 * total) for k, v in term.items()):
            continue
        rest = {k: v for k, v in mine["terms"].items() if k != name}
        without = roofline.hlo_match(ref, mine["per_device"], rest)
        assert any(m["status"] == "differs" for m in without.values()), name
    assert set(mine["port_only"]) == port_only_wanted
    return match
