"""The dry run's per-device collectives of the encdec family (whisper-base,
2 encoder and 2 decoder layers, 64 frames and 64 tokens a row) held to
the reference's compiled HLO (``torch_hlo_gate.hold``) without FSDP:

- at the tool's default shape (4 x 64 on (2, 4)): the encoder split over
  "model" along the features (the frames' split), its output gathered
  for the cross-attention, and the learned positions' gradients reduced
  only at the rows a step reads;
- at ``--batch 1``, its decoder positions over "data": every piece runs
  the same encoder, whose gradients XLA does not reduce (it sums the
  encoder output's gradient instead), and the tied table's gradient is
  reduced twice.

With FSDP (not whisper-base's production placement: 74 M params) XLA
moves the logits and permutes the table's rows; ROADMAP's queue 3 lists
it.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_hlo_gate as G  # noqa: E402

PORT_ONLY = {"column_outputs", "row_input_gradients", "unread_recompute", "untouched_rows"}
CASES = {"default": ["--arch", "whisper-base"],
         "batch1": ["--arch", "whisper-base", "--batch", "1"]}
HELD = [("default", "False", {"hlo_f32"}, PORT_ONLY),
        ("batch1", "False", {"hlo_f32", "hlo_reduce_scatter_as_all_reduce"},
         PORT_ONLY | {"replicated_gradients"})]
_COMPARED = {}


@pytest.mark.parametrize("case,fsdp,terms,port_only", HELD,
                         ids=[f"{c}-{'fsdp' if f == 'True' else 'tp'}" for c, f, _, _ in HELD])
def test_per_device_plus_named_terms_equal_the_reference_hlo(case, fsdp, terms, port_only):
    if case not in _COMPARED:             # one reference compile a shape, FSDP off and on
        _COMPARED[case] = G.compare(CASES[case])
    ref, ours = _COMPARED[case]
    G.hold(ref[fsdp], ours[fsdp], terms, port_only)
