"""The dry run's per-device collectives of the dense family (gemma2-2b, 2
layers) at the reference's two fallback shapes, held to its compiled HLO
(``torch_hlo_gate.hold``: every kind within 2%, or under 1% of the HLO's
total and listed; every named term over 2% of its kind needed):

- ``--microbatches 2 --mesh 4,2`` (2 rows a microbatch over 4 dp
  positions), FSDP off: XLA reduces each microbatch's gradients apart
  (the per-device gradient reduction twice, the tied table's second
  reduction too); with FSDP it keeps the weights split, the logits'
  all-reduce once more a microbatch;
- ``--batch 8 --microbatches 2`` (4 rows a microbatch over 2 dp
  positions), FSDP off and on: XLA reduces each microbatch's gradients
  apart here too (``roofline._apart``);
- ``--batch 1`` (its positions over "data"), FSDP off: the gathers of
  the queries and then k and v stay under 1% and are listed; with FSDP
  XLA keeps the weights split and moves the activations
  (``roofline._stationary_device``).  The default shape is
  ``test_torch_dryrun_per_device.py``'s.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_hlo_gate as G  # noqa: E402

PORT_ONLY = {"column_outputs", "row_input_gradients", "logits"}
CASES = {"microbatches": ["--arch", "gemma2-2b", "--microbatches", "2", "--mesh", "4,2"],
         "batch1": ["--arch", "gemma2-2b", "--batch", "1"],
         "microbatches_split": ["--arch", "gemma2-2b", "--batch", "8", "--microbatches", "2"]}
HELD = [("microbatches", "False", {"hlo_f32", "tied_table_twice"}, PORT_ONLY),
        ("microbatches", "True", {"hlo_f32"}, PORT_ONLY | {"weights_gathered"}),
        ("microbatches_split", "False", {"hlo_f32", "lookup_scatter_gather", "tied_table_twice"},
         PORT_ONLY),
        ("microbatches_split", "True", {"hlo_f32", "hlo_reduce_scatter_as_all_reduce",
                                        "fsdp_backward_gather", "lookup_all_to_all",
                                        "lookup_scatter_gather"}, PORT_ONLY),
        ("batch1", "False", {"hlo_f32", "hlo_reduce_scatter_as_all_reduce", "tied_table_twice"},
         PORT_ONLY),
        ("batch1", "True", {"hlo_f32"}, PORT_ONLY | {"weights_gathered"})]
_COMPARED = {}


@pytest.mark.parametrize("case,fsdp,terms,port_only", HELD,
                         ids=[f"{c}-{'fsdp' if f == 'True' else 'tp'}" for c, f, _, _ in HELD])
def test_per_device_plus_named_terms_equal_the_reference_hlo(case, fsdp, terms, port_only):
    if case not in _COMPARED:             # one reference compile a shape, FSDP off and on
        _COMPARED[case] = G.compare(CASES[case])
    ref, ours = _COMPARED[case]
    G.hold(ref[fsdp], ours[fsdp], terms, port_only)
