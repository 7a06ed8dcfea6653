"""Topic pub/sub bus over TCP JSON lines — the ROS replacement.

Port of ``mrgan_tpu/acquisition/bus.py`` (a copy: it never touched JAX).

Semantics mirror what the acquisition stack needs from rospy: named topics,
fan-out to all subscribers, per-subscriber callback threads, fire-and-forget
publishing (collectdataPoke.py:81-100 topic graph). Unlike ROS there is no
master/XML-RPC layer: one BusServer, N BusClients over localhost sockets.
"""

import json
import socket
import threading
import time


class SimClock:
    """Scaled simulation clock: now() runs ``timescale``x faster than wall
    time. All acquisition components and the firmware simulators share one
    timescale so recorded timestamps look like real-rate data."""

    def __init__(self, timescale=1.0):
        self.timescale = float(timescale)
        self.epoch = time.time()

    def now(self):
        return (time.time() - self.epoch) * self.timescale

    def sleep(self, sim_seconds):
        time.sleep(max(sim_seconds / self.timescale, 0.0))


class BusServer:
    def __init__(self, host="127.0.0.1", port=0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address = self._sock.getsockname()
        self._subs = {}  # topic -> list of client files
        self._lock = threading.Lock()
        self._running = True
        self._accept_thread = threading.Thread(target=self._accept, daemon=True)
        self._accept_thread.start()

    def _accept(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        rfile = conn.makefile("r")
        wfile = conn.makefile("w")
        my_topics = []
        try:
            for line in rfile:
                msg = json.loads(line)
                if msg["op"] == "sub":
                    with self._lock:
                        self._subs.setdefault(msg["topic"], []).append(wfile)
                    my_topics.append(msg["topic"])
                elif msg["op"] == "pub":
                    self._fanout(msg["topic"], line)
        except (OSError, ValueError):
            pass
        finally:
            with self._lock:
                for t in my_topics:
                    if wfile in self._subs.get(t, []):
                        self._subs[t].remove(wfile)
            conn.close()

    def _fanout(self, topic, raw_line):
        with self._lock:
            targets = list(self._subs.get(topic, []))
        for w in targets:
            try:
                w.write(raw_line if raw_line.endswith("\n") else raw_line + "\n")
                w.flush()
            except (OSError, ValueError):
                pass

    def close(self):
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass


class BusClient:
    """Publish/subscribe endpoint. subscribe() callbacks run on a dedicated
    reader thread (like rospy callback threads)."""

    def __init__(self, address):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.connect(tuple(address))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("r")
        self._wfile = self._sock.makefile("w")
        self._wlock = threading.Lock()
        self._callbacks = {}
        self._reader = None

    def publish(self, topic, data):
        with self._wlock:
            self._wfile.write(
                json.dumps({"op": "pub", "topic": topic, "data": data}) + "\n"
            )
            self._wfile.flush()

    def subscribe(self, topic, callback):
        self._callbacks.setdefault(topic, []).append(callback)
        with self._wlock:
            self._wfile.write(json.dumps({"op": "sub", "topic": topic}) + "\n")
            self._wfile.flush()
        if self._reader is None:
            self._reader = threading.Thread(target=self._read_loop, daemon=True)
            self._reader.start()

    def _read_loop(self):
        try:
            for line in self._rfile:
                msg = json.loads(line)
                for cb in self._callbacks.get(msg.get("topic"), []):
                    cb(msg["data"])
        except (OSError, ValueError):
            pass

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
