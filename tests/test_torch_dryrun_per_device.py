"""The dry run's per-device collective term against the reference's HLO.

``tools/torch_hlo_compare.py`` compiles the reference's data-parallel
train step as its dry run builds a train cell (activations split over
"model" along the sequence, the streamed cross-entropy, layers unrolled)
on a (2, 4) mesh of forced CPU devices, in a process of its own:
gemma2-2b at 2 layers, batch 4 x 64, FSDP off and on.  Per collective
kind, ``roofline.train_collectives``' ``per_device`` at the same shape
(meta tensors) plus the terms ``roofline.hlo_terms`` names equals the
compiled per-device HLO within 2%; a kind under 1% of the HLO's total
(the collective-permutes that reshuffle the lookup's rows, and with FSDP
the all-to-all) may stay unmatched and is listed.  Every named term over
2% of its kind is needed: without it a kind differs.
"""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch import roofline  # noqa: E402

TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "torch_hlo_compare.py")
TERMS = {"False": {"hlo_f32", "tied_table_twice", "lookup_scatter_gather"},
         "True": {"hlo_f32", "hlo_reduce_scatter_as_all_reduce", "fsdp_backward_gather",
                  "lookup_all_to_all", "lookup_scatter_gather"}}


@pytest.fixture(scope="module")
def compared():
    spec = importlib.util.spec_from_file_location("torch_hlo_compare", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args = tool.parser().parse_args([])
    ref = tool.run_reference(args)["bytes"]
    return ref, tool.port(args)


@pytest.mark.parametrize("fsdp", ["False", "True"], ids=["tp", "fsdp"])
def test_per_device_plus_named_terms_equal_the_reference_hlo(compared, fsdp):
    ref, ours = compared
    mine = ours[fsdp]
    assert set(mine["terms"]) == TERMS[fsdp]
    match = roofline.hlo_match(ref[fsdp], mine["per_device"], mine["terms"])
    total = sum(ref[fsdp].values())
    assert {k for k, m in match.items() if m["status"] == "matched"} == {"all-gather",
                                                                         "all-reduce"}
    for kind, m in match.items():
        assert m["status"] != "differs", (kind, m)
        if m["status"] == "matched":
            assert abs(m["sum"] - m["hlo"]) <= 0.02 * m["hlo"], kind
        else:
            assert max(m["hlo"], m["sum"]) < 0.01 * total, kind
    unmatched = {k for k, m in match.items() if m["status"] == "unmatched" and m["hlo"]}
    assert unmatched == ({"collective-permute", "all-to-all"} if fsdp == "True"
                         else {"collective-permute"})
    # each term is needed where it is over 2% of its kind's HLO bytes (the
    # lookup's scatter gathers are 5.7% of the all-gathers without FSDP,
    # 0.08% with it)
    needed = 0
    for name, term in mine["terms"].items():
        if not any(abs(v) > 0.02 * ref[fsdp].get(k, 0.0) for k, v in term.items()):
            continue
        needed += 1
        rest = {k: v for k, v in mine["terms"].items() if k != name}
        without = roofline.hlo_match(ref[fsdp], mine["per_device"], rest)
        assert any(m["status"] == "differs" for m in without.values()), name
    assert needed == len(mine["terms"]) - (fsdp == "True")
    # the port's own gathers, none of which the HLO holds, are listed apart
    assert set(mine["port_only"]) == {"column_outputs", "row_input_gradients", "logits"}
