"""`repro_torch.data.synth.make_dataset` against the reference's
`make_dataset`: every array bit for bit, on the paper's query shapes
(TAXI 7548 x 24, FLIGHTS 161 x 7 with the matches in the Zipf tail, a
uniform target). The name of the test is kept from when the port could
also sort on a torch device."""

import dataclasses

import numpy as np
import pytest

from repro.data import synth as jsynth
from repro_torch.data import synth as tsynth

SPECS = {
    "taxi": dict(v_z=7548, v_x=24, num_tuples=300_000, seed=0),
    "flights_tail": dict(v_z=161, v_x=7, num_tuples=200_000, close_rank="tail", seed=1),
    "uniform": dict(v_z=64, v_x=12, num_tuples=100_000, target_kind="uniform", seed=2),
}
FIELDS = ("z", "x", "target", "true_dists", "true_hists", "gen_hists", "close_ids")


@pytest.mark.parametrize("name", SPECS)
def test_device_sort_is_bitwise(name):
    kw = SPECS[name]
    got = tsynth.make_dataset(tsynth.SynthSpec(**kw))
    ref = jsynth.make_dataset(jsynth.SynthSpec(**kw))
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(ref.spec)
    for field in FIELDS:
        a, c = getattr(got, field), getattr(ref, field)
        assert a.dtype == c.dtype, field
        assert np.array_equal(a, c), field
