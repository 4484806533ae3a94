"""The port's shared-memory channels (``ray_tpu_torch.experimental
.channel``), through the JAX package's scenarios with their own inputs
and assertions: tests/test_channel.py (6) — a bytes round trip, objects
through a wrapping ring, backpressure and close, a threaded producer and
consumer, a driver reading an actor worker's ring on the port's cluster,
and a ShmCommunicator allreduce over threads. Beside them: a CPU tensor
through put/get, and the two packages' rings read each other's bytes
(the port's ``csrc/channel.cc`` is the JAX package's source, and both
segments live in /dev/shm)."""

import os
import pickle
import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch as ray_tpu
from ray_tpu.experimental import channel as jchannel
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.experimental.channel import (
    Channel,
    ChannelClosed,
    ShmCommunicator,
)


def test_channel_roundtrip_bytes():
    ch = Channel(capacity=1 << 16)
    try:
        ch.put_bytes(b"hello")
        ch.put_bytes(b"world" * 100)
        assert ch.get_bytes(timeout=5) == b"hello"
        assert ch.get_bytes(timeout=5) == b"world" * 100
    finally:
        ch.destroy()


def test_channel_objects_and_wraparound():
    ch = Channel(capacity=1 << 12)  # small: forces ring wrap
    try:
        for i in range(200):
            ch.put({"i": i, "pad": b"x" * 100}, timeout=5)
            got = ch.get(timeout=5)
            assert got["i"] == i
    finally:
        ch.destroy()


def test_channel_backpressure_and_close():
    ch = Channel(capacity=1 << 12)
    try:
        with pytest.raises(TimeoutError):
            while True:
                ch.put_bytes(b"y" * 512, timeout=0.2)
        ch.close()
        with pytest.raises(ChannelClosed):
            ch.put_bytes(b"z")
        # drain what's there, then closed signal
        while True:
            try:
                ch.get_bytes(timeout=0.2)
            except ChannelClosed:
                break
    finally:
        ch.destroy()


def test_channel_threaded_producer_consumer():
    ch = Channel(capacity=1 << 14)
    N = 500
    out = []

    def producer():
        for i in range(N):
            ch.put_bytes(i.to_bytes(4, "little"), timeout=10)

    t = threading.Thread(target=producer)
    t.start()
    try:
        for _ in range(N):
            out.append(int.from_bytes(ch.get_bytes(timeout=10), "little"))
        t.join()
        assert out == list(range(N))
    finally:
        ch.destroy()


def test_channel_cross_process():
    """Driver <-> actor worker over the shm ring (bypasses RPC)."""
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    c.wait_for_nodes()
    ray_tpu.init(address=c.address)
    try:
        ch = Channel(capacity=1 << 16)

        @ray_tpu.remote
        class Producer:
            def produce(self, name, n):
                from ray_tpu_torch.experimental.channel import Channel as Ch

                out = Ch(name=name, create=False)
                for i in range(n):
                    out.put({"seq": i, "data": np.arange(4) * i}, timeout=30)
                return "done"

        p = Producer.remote()
        ref = p.produce.remote(ch.name, 50)
        for i in range(50):
            msg = ch.get(timeout=30)
            assert msg["seq"] == i
            assert int(msg["data"][1]) == i
        assert ray_tpu.get(ref, timeout=60) == "done"
        ch.destroy()
    finally:
        ray_tpu.shutdown()
        c.shutdown()


def test_shm_communicator_allreduce_threads():
    # a group name of its own: the JAX package's copy of this test
    # names its rings rtc_g1_* in the same /dev/shm
    comms = [ShmCommunicator(f"tg1_{os.getpid()}", 3, r) for r in range(3)]
    results = [None] * 3

    def run(r):
        results[r] = comms[r].allreduce(np.full(4, float(r + 1)))

    ts = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for r in results:
        np.testing.assert_array_equal(r, np.full(4, 6.0))
    for c in comms:  # each unlinks the rings it created
        c.destroy()


# ------------------------------------------------------------ the port's own


def test_channel_cpu_tensor_roundtrip():
    """A CPU tensor crosses through the port's pickler: same dtype,
    shape and values, and the reader's copy is its own (writable, and
    a write does not reach the ring)."""
    ch = Channel(capacity=1 << 16)
    try:
        x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
        bf = torch.linspace(-1, 1, 9, dtype=torch.bfloat16)
        ch.put({"x": x, "bf": bf, "tag": "t"}, timeout=5)
        got = ch.get(timeout=5)
        assert got["tag"] == "t"
        assert got["x"].dtype == torch.float32 and got["x"].shape == x.shape
        assert torch.equal(got["x"], x)
        assert got["bf"].dtype == torch.bfloat16 and torch.equal(got["bf"], bf)
        got["x"][0, 0, 0] = 99.0
        assert x[0, 0, 0] == 0.0
    finally:
        ch.destroy()


def _messages():
    """Seeded messages whose lengths make a 4 KiB ring wrap, with and
    without a tail shorter than the length prefix."""
    rng = np.random.default_rng(3)
    return [rng.bytes(int(n)) for n in rng.integers(0, 1500, 60)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rings_read_across_packages(writer):
    """A ring one package writes, the other reads, message for message;
    after the same writes both packages' segments hold the same bytes."""
    W, R = (jchannel.Channel, Channel) if writer == "jax" else \
        (Channel, jchannel.Channel)
    w = W(capacity=1 << 12)
    r = R(name=w.name, create=False)
    twin = R(capacity=1 << 12)
    try:
        for m in _messages():
            w.put_bytes(m, timeout=5)
            twin.put_bytes(m, timeout=5)
            assert bytes(w._seg.buf) == bytes(twin._seg.buf)
            assert r.get_bytes(timeout=5) == m
            assert twin.get_bytes(timeout=5) == m
        # objects: each package's own encoding, read back raw
        w.put({"k": [1, 2.5, "x"]}, timeout=5)
        raw = r.get_bytes(timeout=5)
        if writer == "jax":
            assert pickle.loads(raw) == {"k": [1, 2.5, "x"]}
        else:
            assert raw == ser.dumps({"k": [1, 2.5, "x"]})
        w.close()
        with pytest.raises((ChannelClosed, jchannel.ChannelClosed)):
            r.get_bytes(timeout=1)
    finally:
        twin.destroy()
        w.destroy()
