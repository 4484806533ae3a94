"""Head restart recovery through pluggable storage on the port's
cluster runtime, through the JAX package's scenarios with their own
inputs and assertions: tests/test_head_storage.py (2).

Reference model: gcs_client_reconnection_test.cc / GCS restarts from
Redis. The second scenario starts its own head and nodelet, as the JAX
one does. Every get carries a timeout.
"""

import ray_tpu_torch as ray
from ray_tpu_torch.core.head import Head
from ray_tpu_torch.core.head_storage import FileHeadStore
from ray_tpu_torch.core.nodelet import Nodelet
from ray_tpu_torch.core.rpc import RpcClient


def test_file_store_roundtrip(tmp_path):
    st = FileHeadStore(str(tmp_path / "hs"))
    st.put("t", b"\x01\x02", b"value1")
    st.put("t", "strkey", b"value2")
    assert st.get("t", b"\x01\x02") == b"value1"
    assert dict(st.scan("t")) == {b"\x01\x02": b"value1",
                                  "strkey": b"value2"}
    st.delete("t", "strkey")
    assert st.get("t", "strkey") is None


def test_head_restart_recovers_kv_and_actor_registry(tmp_path):
    storage_dir = str(tmp_path / "head_meta")
    client = RpcClient.shared()

    head = Head(storage=FileHeadStore(storage_dir)).start()
    nl = Nodelet(head.address, {"CPU": 4},
                 session_dir=str(tmp_path / "sess")).start()
    try:
        ray.init(address=head.address)

        client.call(head.address, "kv_put",
                    {"ns": "app", "key": "cfg", "overwrite": True},
                    frames=[b"persisted-bytes"], timeout=30)

        @ray.remote
        class Named:
            def ping(self):
                return "ok"

        a = Named.options(name="survivor").remote()
        assert ray.get(a.ping.remote(), timeout=60) == "ok"
    finally:
        ray.shutdown()
        nl.stop()
        head.stop()

    # new head incarnation on the same storage
    head2 = Head(storage=FileHeadStore(storage_dir)).start()
    try:
        v, frames = client.call_frames(
            head2.address, "kv_get", {"ns": "app", "key": "cfg"}, timeout=30)
        assert v["found"] and frames[0] == b"persisted-bytes"
        actors = client.call(head2.address, "list_actors", {},
                             timeout=30)["actors"]
        assert any(x["name"] == "survivor" and x["state"] == "DEAD"
                   for x in actors)
    finally:
        head2.stop()
