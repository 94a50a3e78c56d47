"""The seeded weights of the accepted configurations, frozen: the sha256 of
``data.make_weights`` at full size on the CPU, by name, shape, dtype and
bytes in name order, at a small and a large seed.  Drawing by a reference
module's ``INIT`` has to give every configuration without a draw of its own
the same bytes as the fixed table it replaced."""

import hashlib
import json
import os

import pytest

from benchmark.harness import data

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")
LARGE = 2 ** 31 + 12345


def digest(weights) -> str:
    h = hashlib.sha256()
    for k in sorted(weights):
        t = weights[k].detach().contiguous().cpu()
        h.update(k.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config,seed,sha256", [
    ("hrradarpose_doppler", 7,
     "0cdc9b44e9ec07a9a9a07a335108c26b0179c041011ee9c2bd54e68e21d412ef"),
    ("hrradarpose_doppler", LARGE,
     "a3af7706427cfd6a335575798de06f2ecd606c89fe1214e5545ba03e5fd01bd2"),
    ("hrradarpose_phase", 7,
     "218e26242423959028b67ed766eaf93e7dbe7904187e844570245003ed743a92"),
    ("hrradarpose_phase", LARGE,
     "d355e8cbb72b311da9f219d39a3cf62473b645ba5bfb17358efc3c69e0c168e5"),
])
def test_weights_are_those_of_the_fixed_table(config, seed, sha256):
    with open(os.path.join(CONFIGS, f"{config}.json")) as f:
        cfg = json.load(f)
    assert digest(data.make_weights(cfg, seed, "cpu")) == sha256
