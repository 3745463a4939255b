"""The serve worker's heartbeat against its answers
(``improved_body_parts_torch.serve.worker``): the served count in the
heartbeat row already holds a request when the worker sends that
request's ``done`` token, so a parent that reads ``worker_stats()`` as
soon as a future resolves never sees a count one short.  The JAX
package's worker beats after the token; under load the port's
``tests/test_torch_fleet_tools.py::test_off_router_moves_only_the_
heartbeat`` read 5 of 6 once for that reason.

``worker_main`` runs on a thread of this process over a real shared
memory region and task pipe, with a ``done`` channel that reads the
heartbeat row at each send.
"""
import json
import multiprocessing
import queue
import threading
from multiprocessing import shared_memory

import numpy as np
import pytest

from improved_body_parts_torch.data.shm_ring import (
    _quiet_close,
    _slot_views,
)
from improved_body_parts_torch.obs.events import get_sink, set_sink
from improved_body_parts_torch.obs.trace import get_tracer, set_tracer
from improved_body_parts_torch.serve import worker

SLOTS, HW, PARTS, PEOPLE = 2, (32, 32), 18, 4


class _DoneChannel:
    """Stands in for the worker's ``done`` pipe end: each message is
    queued with the heartbeat's served count read at the send."""

    def __init__(self, hb):
        self.hb = hb
        self.got = queue.Queue()

    def send(self, msg):
        self.got.put((msg, float(self.hb[1])))


@pytest.mark.parametrize("telemetry", [False, True],
                         ids=["telemetry_off", "telemetry_on"])
def test_served_count_leads_each_done_token(telemetry):
    _, shapes, dtypes = worker.wire_format(HW, PARTS, PEOPLE)
    shm = shared_memory.SharedMemory(
        create=True, size=worker.region_size(SLOTS, shapes, dtypes))
    shm.buf[:] = b"\x00" * len(shm.buf)
    hb = worker.hb_view(shm.buf, SLOTS, shapes, dtypes, writeable=False)
    _, views = _slot_views(shm.buf, SLOTS, shapes, dtypes, writeable=True)
    task_r, task_w = multiprocessing.Pipe(duplex=False)
    done = _DoneChannel(hb)
    prev = get_sink(), get_tracer()
    t = threading.Thread(target=worker.worker_main, args=(
        0, shm.name, SLOTS, shapes, dtypes,
        "improved_body_parts_torch.serve.worker:constant_predictor",
        json.dumps({"num_parts": PARTS, "n_people": 2}, allow_nan=False),
        task_r, done, 0),
        kwargs={"max_batch": 1, "telemetry": telemetry}, daemon=True)
    try:
        t.start()
        rng = np.random.default_rng(0)
        for n in range(1, 6):
            slot = n % SLOTS
            img, meta_in = views[slot][0], views[slot][1]
            img[:] = rng.integers(0, 255, img.shape, dtype=np.uint8)
            meta_in[:] = [HW[0], HW[1], 0.0, 0.0]
            task_w.send(("req", slot, 2 * n))
            msg, served = done.got.get(timeout=30)
            assert msg == ("done", 0, slot, 2 * n)
            assert served == n
        task_w.send(None)
        t.join(30)
        assert not t.is_alive()
    finally:
        set_sink(prev[0])
        set_tracer(prev[1])
        task_w.close()
        task_r.close()
        # this frame's views still point into the mapping
        _quiet_close(shm)
        shm.unlink()
