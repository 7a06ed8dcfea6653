"""Sensor publisher nodes: serial (firmware sim) -> bus topics.

Port of ``mrgan_tpu/acquisition/publishers.py`` (it never touched JAX), with
one change: in 'zeroing' both publishers publish one reading every
1 / ZEROING_HZ sim seconds, not every line. The orchestrator takes 20
readings for its zero offsets and polls the temperature twice a sim second
while it reheats; at the line rates (100 Hz of sim time for the
temperature, up to 25,000 lines a second of wall time for the contact mic)
the JSON bus queues thousands of readings in socket buffers during a
reheat, faster than the orchestrator's reader takes them, and the bulk
replay after a poke's "stop" waits behind them past its deadline.

State machines mirror datacollection/publishers/temperaturepublisher.py and
contactmicpublisher.py:

- 'zeroing': publish individual readings so the orchestrator can compute
  zero-offsets (temperaturepublisher.py:75-78);
- 'start' -> 'record': buffer (time, value) pairs; the temperature publisher
  watches for a >1 C delta from the first 10 samples and, on detection,
  sends the firmware 'H' hold command and publishes the collision time
  (:86-93);
- 'contact' message: immediate 'H' (datastate callback, :45-51);
- 'stop': bulk-publish the whole recording as one flat array (times then
  values; temperature interleaves (raw, celsius) pairs) and re-enable
  temperature control with 'C' (:95-109).
"""

import threading

import numpy as np

from . import serialdev
from .bus import BusClient

ZEROING_HZ = 20.0  # readings published a sim second in 'zeroing'


def main(argv=None):
    """Run one publisher as a standalone OS process (the reference runs
    temperaturepublisher.py / contactmicpublisher.py as separate ROS nodes):

        python -m mrgan_tpu_torch.acquisition.publishers \
            --role temperature --bus-host 127.0.0.1 --bus-port 5555
    """
    import argparse

    from .bus import SimClock

    parser = argparse.ArgumentParser(description="Sensor publisher node.")
    parser.add_argument("--role", choices=("temperature", "contactmic"),
                        required=True)
    parser.add_argument("--bus-host", default="127.0.0.1")
    parser.add_argument("--bus-port", type=int, required=True)
    parser.add_argument("--timescale", type=float, default=1.0)
    parser.add_argument("--rate", type=float, default=4000.0,
                        help="contact-mic sample rate (sim Hz)")
    args = parser.parse_args(argv)

    clock = SimClock(args.timescale)
    address = (args.bus_host, args.bus_port)
    if args.role == "temperature":
        node = TemperaturePublisher(address, clock, timescale=args.timescale)
    else:
        node = ContactMicPublisher(address, clock, timescale=args.timescale,
                                   rate=args.rate)
    node.start()
    node.join()


class PublisherBase(threading.Thread):
    def __init__(self, bus_address, clock, dev):
        super().__init__(daemon=True)
        self.clock = clock
        self.dev = dev
        self.client = BusClient(bus_address)
        self.state = "stop"
        self._running = True
        self.client.subscribe("/semihaptics/datastate", self._datastate)

    def _datastate(self, msg):
        raise NotImplementedError

    def stop(self):
        self._running = False

    def close(self):
        self.stop()
        self.dev.close()
        self.client.close()


class TemperaturePublisher(PublisherBase):
    """temperaturepublisher.py equivalent over the thermal_sim firmware."""

    def __init__(self, bus_address, clock, dev=None, timescale=1.0):
        dev = dev or serialdev.setup_serial(
            serialdev.thermal_sim_argv(timescale=timescale))
        super().__init__(bus_address, clock, dev)
        self.contact = False

    def _datastate(self, msg):
        if msg.lower() == "contact":
            # Send hold command (temperaturepublisher.py:47-51)
            self.dev.write("H")
            self.contact = True
        else:
            if msg.lower() in ("start",):
                self.dev.drain()
            self.state = msg.lower()

    def run(self):
        data, times = [], []
        t = self.clock.now()
        next_zero = t
        while self._running:
            if self.state == "zeroing":
                values = serialdev.get_data(self.dev, 2)
                now = self.clock.now()
                if values and now >= next_zero:
                    self.client.publish("/semihaptics/temperature", values)
                    next_zero = now + 1.0 / ZEROING_HZ
            elif self.state == "start":
                t = self.clock.now()
                data, times = [], []
                self.state = "record"
            elif self.state == "record":
                values = serialdev.get_data(self.dev, 2)
                if not values:
                    continue
                data.append(values)
                times.append(self.clock.now())
                # contact detection: >1 C delta vs the first 10 samples
                if (not self.contact and len(data) > 10
                        and abs(data[-1][-1]
                                - np.mean([d[-1] for d in data[:10]])) > 1):
                    self.dev.write("H")
                    self.contact = True
                    self.client.publish("/semihaptics/collisiontime",
                                        self.clock.now() - t)
            else:
                if self.contact:
                    self.dev.write("C")  # re-enable control (:97-100)
                    self.contact = False
                if data or times:
                    flat = ([tt - t for tt in times]
                            + np.asarray(data).flatten().tolist())
                    self.client.publish("/semihaptics/temperature", flat)
                    data, times = [], []
                self.clock.sleep(0.0001)


class ContactMicPublisher(PublisherBase):
    """contactmicpublisher.py equivalent over the contactmic_sim firmware."""

    def __init__(self, bus_address, clock, dev=None, timescale=1.0,
                 rate=4000.0):
        dev = dev or serialdev.setup_serial(
            serialdev.contactmic_sim_argv(timescale=timescale, rate=rate))
        super().__init__(bus_address, clock, dev)

    def _datastate(self, msg):
        if msg.lower() != "contact":
            if msg.lower() == "start":
                self.dev.drain()
            self.state = msg.lower()

    def run(self):
        data, times = [], []
        t = self.clock.now()
        last_t = -1.0
        next_zero = self.clock.now()
        while self._running:
            if self.state == "zeroing":
                value = serialdev.get_data(self.dev, 1, max_value=10000)
                now = self.clock.now()
                if value != [] and now >= next_zero:
                    self.client.publish("/semihaptics/contactmic", [value])
                    next_zero = now + 1.0 / ZEROING_HZ
            elif self.state == "start":
                t = self.clock.now()
                data, times = [], []
                last_t = -1.0
                self.state = "record"
            elif self.state == "record":
                value = serialdev.get_data(self.dev, 1, max_value=10000)
                if value == []:
                    continue
                now = self.clock.now()
                if now <= last_t:  # burst reads: keep timestamps monotonic
                    now = last_t + 1e-6
                last_t = now
                data.append(value)
                times.append(now)
            else:
                if data or times:
                    flat = [tt - t for tt in times] + data
                    self.client.publish("/semihaptics/contactmic", flat)
                    data, times = [], []
                self.clock.sleep(0.0001)


class CameraPublisher(threading.Thread):
    """Kinect stand-in: publishes frames of the staged object on
    /semihaptics/image so the orchestrator's grabImage
    (collectdataPoke.py:178-190, a wait-for-next-message on that topic) works
    against the sim stack.

    The rendered scene is deterministic per (object_name, material): a
    material-colored blob with object-seeded shape/texture over a noisy
    tabletop — enough structure that downstream consumers of
    objectImage/images can tell objects apart, cheap enough to ship over the
    JSON-line bus (base64 rgb8, ~19 KB/frame at 60x80)."""

    MATERIAL_COLORS = {
        "plastic": (200, 60, 60), "glass": (120, 190, 220),
        "fabric": (170, 130, 60), "metal": (160, 160, 175),
        "wood": (140, 95, 45), "ceramic": (225, 220, 205),
    }

    def __init__(self, bus_address, clock, object_name="object",
                 material="plastic", rate=2.0, shape=(60, 80)):
        super().__init__(daemon=True)
        self.clock = clock
        self.client = BusClient(bus_address)
        self.rate = rate
        self.shape = shape
        self.object_name = object_name
        self.material = material
        self._running = True
        self._frame = self._render()

    def _render(self):
        import zlib

        h, w = self.shape
        rng = np.random.RandomState(
            zlib.crc32(self.object_name.encode()) & 0x7FFFFFFF)
        img = 115.0 + 8.0 * rng.randn(h, w, 3)  # tabletop + sensor noise
        color = np.array(self.MATERIAL_COLORS.get(self.material, (128,) * 3),
                         float)
        cy = h / 2 + rng.uniform(-h / 10, h / 10)
        cx = w / 2 + rng.uniform(-w / 10, w / 10)
        ry = rng.uniform(h / 6, h / 3)
        rx = rng.uniform(w / 6, w / 3)
        yy, xx = np.mgrid[0:h, 0:w]
        mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        stripes = 0.15 * np.sin(2 * np.pi * rng.uniform(2, 8) * xx / w
                                + rng.uniform(0, 2 * np.pi))
        shade = color[None, None, :] * (0.85 + stripes + 0.05
                                        * rng.randn(h, w))[..., None]
        img = np.where(mask[..., None], shade, img)
        return np.clip(img, 0, 255).astype(np.uint8)

    def run(self):
        import base64

        h, w = self.shape
        payload = {
            "h": h, "w": w, "encoding": "rgb8",
            "data": base64.b64encode(self._frame.tobytes()).decode("ascii"),
        }
        period = 1.0 / self.rate
        while self._running:
            self.client.publish("/semihaptics/image", payload)
            self.clock.sleep(period)

    def stop(self):
        self._running = False

    def close(self):
        self.stop()
        self.client.close()


if __name__ == "__main__":
    main()
