"""The reference accepts a proof of each kind made by the program's batch
path and rejects it with one byte flipped, against another op's statement,
or at another width than the deployment's.

``data/proofs.json`` holds one proof of each kind from ``process_batch`` on
the CPU under the ``libzkp-mixed6`` deployment's keys (made from its key
seed, so the same keys again here)."""

import json
from pathlib import Path

import pytest

from zkbench import harness, keys
from zkbench.reference.verify import verdicts

DATA = json.loads((Path(__file__).parent / "data" / "proofs.json").read_text())
KINDS = [d["kind"] for d in DATA]


def _args(d):
    return tuple(tuple(a) if isinstance(a, list) else a for a in d["args"])


@pytest.fixture(scope="module")
def vks(tmp_path_factory):
    keys.KEY_ROOT, saved = tmp_path_factory.mktemp("keys"), keys.KEY_ROOT
    try:
        yield keys.verifying_keys(keys.ensure(harness.Cell("mixed6.b1024").config))
    finally:
        keys.KEY_ROOT = saved


def _one(vks, kind, args, proof, bits=64):
    return verdicts([(kind, args, proof)], bits=bits, vks=vks)[0]


@pytest.mark.parametrize("i", range(len(DATA)), ids=KINDS)
def test_accepts_the_programs_proof(vks, i):
    d = DATA[i]
    assert _one(vks, d["kind"], _args(d), bytes.fromhex(d["proof"]))


@pytest.mark.parametrize("i", range(len(DATA)), ids=KINDS)
@pytest.mark.parametrize("where", [0.25, 0.5, 0.9])
def test_rejects_one_flipped_byte(vks, i, where):
    d = DATA[i]
    proof = bytearray.fromhex(d["proof"])
    proof[int(len(proof) * where)] ^= 0x01
    assert not _one(vks, d["kind"], _args(d), bytes(proof))


def _other_statement(kind, args):
    if kind == "range":
        return (args[0], args[1] + 1, args[2])
    if kind == "threshold":
        return (args[0], args[1] + 1)
    if kind == "consistency":
        return (args[0] + (args[0][-1],),)
    if kind == "equality":
        return (args[0] + 1, args[1] + 1)
    if kind == "membership":
        return (args[1][0] if args[1][0] != args[0] else args[1][1], args[1])
    return (args[0] + 1, args[1])


@pytest.mark.parametrize("i", range(len(DATA)), ids=KINDS)
def test_rejects_another_statement(vks, i):
    d = DATA[i]
    assert not _one(vks, d["kind"], _other_statement(d["kind"], _args(d)), bytes.fromhex(d["proof"]))


@pytest.mark.parametrize("kind", ["range", "threshold", "consistency"])
def test_rejects_another_width(vks, kind):
    d = DATA[KINDS.index(kind)]
    assert not _one(vks, kind, _args(d), bytes.fromhex(d["proof"]), bits=32)


def test_a_sample_of_mixed_kinds_gets_one_verdict_each(vks):
    items = [(d["kind"], _args(d), bytes.fromhex(d["proof"])) for d in DATA]
    bad = bytearray(items[1][2])
    bad[len(bad) // 2] ^= 0x01
    items.insert(2, (items[1][0], items[1][1], bytes(bad)))
    assert verdicts(items, bits=64, vks=vks) == [True, True, False] + [True] * (len(DATA) - 2)
