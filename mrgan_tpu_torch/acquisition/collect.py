"""CollectData orchestrator (datacollection/collectdataPoke.py).

Port of ``mrgan_tpu/acquisition/collect.py``: the same state machine, names
and saved pickle schema, with two changes:

- the classifier hook: only a poke the classifier cannot window
  (``data.preprocess.ShortWindowError``) is printed and skipped; any other
  error (a CUDA, build or kernel launch error on the serving path) stops
  the run;
- a zeroing-state reading that reaches the orchestrator late, after a
  poke's "stop" (the bus delivers in order, and the contact mic's zeroing
  stream can queue up behind the reader), is not taken for the poke's bulk
  replay. The JAX package's orchestrator takes it: a contact-mic reading
  records an empty contact stream for the poke, and a temperature reading
  fails to reshape, which ends the bus reader thread and times the
  collection out ("bulk sensor replay not received").

Behavioral mirror of the reference's poke state machine, headless and
sim-clocked:

- zeroData: publish 'zeroing', wait until force/accel/temperature/contactmic
  zero-offsets (means of 20 readings) are all established (:191-206);
- per poke: beginNewDataSequence -> random 1.5-2.5 s gripper motion ->
  spin until force > 1 N on taxel 3/4 OR temperature-collision message OR
  7 s timeout (:316,329-342) -> publish 'contact' (the temp publisher holds
  the heater) -> 4 s dwell -> 'stop' -> wait for both bulk replays
  (:350-359) -> collisionTime = min(force, temperature) (:362);
- batch pickle save every saveBatchSize pokes with the reference's filename
  scheme + --startcount resume (:392-395,425);
- reheat-to-55 +/- 0.5 C gate between pokes (:233-243).
"""

import os
import pickle

import numpy as np

from ..data.preprocess import ShortWindowError
from .bus import BusClient
from .controller import FORCE_PER_UNIT, TACTILE_AREA


class CollectData:
    def __init__(self, object_name, bus_address, clock, controller,
                 sequences_per_object=25, start_count=0, save_batch_size=25,
                 vertical_movement=False, poke_distance=0.1,
                 data_dir="data_raw", hz=1000, verbose=False,
                 flat=False, quarterflat=False, rotateonce=False,
                 handle=False, neverrotate=False, pause_input=None,
                 classifier=None, capture_images=True,
                 per_poke_images=False, image_timeout=5.0,
                 width=0.0, length=0.0, height=0.0, height_offset=0.0,
                 init_width=0.0, curvedsurface=False):
        self.objectName = object_name
        self.clock = clock
        self.control = controller
        self.sequencesPerObject = sequences_per_object
        self.startCount = start_count
        self.saveBatchSize = save_batch_size
        self.vertical = vertical_movement
        self.pokeDistance = poke_distance
        self.dataDir = data_dir
        self.hz = hz
        self.verbose = verbose
        # object-geometry flags (collectdataPoke.py:411-428): they set the
        # initial gripper pose (:45-54), the poke travel (:320), and the
        # per-poke start-position randomization (:374-379)
        self.width = width
        self.length = length
        self.height = height
        self.curvedsurface = curvedsurface
        if not vertical_movement:
            # right gripper backs off by the object length; heightoffset
            # raises the poke line (collectdataPoke.py:45-49)
            self.initRightPos = np.array(
                [0.495, -0.1 - length, 0.08 + height_offset])
            self.initRightRPY = np.array([0.0, 0.0, np.pi / 2.0])
            self.initLeftPos = np.array([0.5, 0.0, 0.0])
        else:
            # vertical pokes start above the object top (:51-54)
            self.initRightPos = np.array(
                [0.5 + init_width, -0.12, 0.02 + height])
            self.initRightRPY = np.array([0.0, np.pi / 2.0, np.pi / 2.0])
            self.initLeftPos = np.array([0.5, -0.1, -0.1])
        # platter-rotation geometry flags (collectdataPoke.py:411-428): the
        # left gripper holds the object platter; rotating its wrist between
        # pokes lands each poke on a fresh spot
        self.flat = flat
        self.quarterflat = quarterflat
        self.rotateonce = rotateonce
        self.handle = handle
        self.neverrotate = neverrotate
        # pause hook (collectdataPoke.py:301-305 polls stdin via select);
        # None = poll sys.stdin when it is a tty, callable = injected check
        # returning True when the operator asked to pause (tests use this)
        self.pauseInput = pause_input
        # online material recognition (beyond the reference, which only
        # records): anything with classify_raw_poke(dataAll) — normally a
        # serve.MaterialClassifier — is called after each poke's bulk replay
        # and the prediction is published on /semihaptics/prediction;
        # predictions holds (poke index, prediction) pairs
        self.classifier = classifier
        self.predictions = []
        # Kinect capture (collectdataPoke.py:178-190): objectImage is grabbed
        # once per interaction; per-poke images mirror the reference's
        # (commented-out, :366) per-iteration grab and default off
        self.captureImages = capture_images
        self.perPokeImages = per_poke_images
        self.imageTimeout = image_timeout
        self._image_frame = None
        self._image_seq = 0

        self.zeroing = False
        self.recording = False
        self.waitingForData = False
        self.reheating = False
        self.startTime = 0.0

        self.RGripRFingerForce = np.zeros(22)
        self.RGripRFingerForceMean = None
        self.RGripRFingerForceRecent = []
        self.accelMean = None
        self.accelRecent = []
        self.temperatureMean = None
        self.temperatureRecent = []
        self.contactmicMean = None
        self.contactmicRecent = []
        self.temperatureDataReceived = False
        self.contactmicDataReceived = False
        self.temperatureReheat = 0.0
        self.collisionTimeTemp = 10000
        self.collisionTimeForce = 10000

        self.resetData()

        self.client = BusClient(bus_address)
        self.client.subscribe("/pressure/r_gripper_motor",
                              self.rGripperForceCallback)
        self.client.subscribe("/accelerometer/r_gripper_motor",
                              self.accelerometerCallback)
        self.client.subscribe("/semihaptics/temperature",
                              self.temperatureCallback)
        self.client.subscribe("/semihaptics/contactmic",
                              self.contactmicCallback)
        self.client.subscribe("/semihaptics/collisiontime",
                              self.collisionTimeCallback)
        self.client.subscribe("/semihaptics/image", self._imageCallback)
        self.statePublisher = lambda s: self.client.publish(
            "/semihaptics/datastate", s)

    # -- data management (collectdataPoke.py:107-231) -----------------------

    def resetData(self):
        # the full 17-key schema of collectdataPoke.py:106 — saved pickles
        # are key-compatible with the reference's
        self.dataAll = {
            "objectImage": None, "images": [],
            "RGripRFingerTime": [], "RGripRFingerForceRaw": [],
            "RGripRFingerForce": [], "RGripRFingerPressure": [],
            "RGripRFingerPressureRaw": [],
            "temperatureTime": [], "temperatureRaw": [], "temperature": [],
            "accelerometerTime": [], "accelerometerRaw": [],
            "accelerometer": [], "contactmicTime": [], "contactmicRaw": [],
            "contactmic": [], "collisionTime": [],
        }

    def _imageCallback(self, msg):
        import base64

        frame = np.frombuffer(base64.b64decode(msg["data"]), np.uint8)
        self._image_frame = frame.reshape(msg["h"], msg["w"], 3)
        self._image_seq += 1

    def grabImage(self, timeout=None):
        """Kinect grab (collectdataPoke.py:178-190): wait for the NEXT frame
        on /semihaptics/image; None when no camera publishes within the
        timeout (the reference returns None on a bridge error)."""
        timeout = self.imageTimeout if timeout is None else timeout
        seq0 = self._image_seq
        deadline = self.clock.now() + timeout
        while self._image_seq == seq0:
            if self.clock.now() > deadline:
                return None
            self.clock.sleep(0.01)
        return self._image_frame

    def collisionTimeCallback(self, msg):
        self.collisionTimeTemp = msg

    def rGripperForceCallback(self, msg):
        raw = np.array(msg["r_finger_tip"])
        if self.zeroing and self.RGripRFingerForceMean is None:
            self.RGripRFingerForceRecent.append(raw)
            if len(self.RGripRFingerForceRecent) >= 20:
                self.RGripRFingerForceMean = np.mean(
                    self.RGripRFingerForceRecent, axis=0)
        elif self.RGripRFingerForceMean is not None:
            self.RGripRFingerForce = (raw - self.RGripRFingerForceMean) / \
                FORCE_PER_UNIT
            pressure = self.RGripRFingerForce / TACTILE_AREA / 1000.0
            # reference quirk (collectdataPoke.py:123): PressureRaw is
            # computed from the UN-zeroed raw counts — no mean subtraction
            pressure_raw = (raw / FORCE_PER_UNIT) / TACTILE_AREA / 1000.0
            if self.recording:
                self.dataAll["RGripRFingerTime"][-1].append(
                    self.clock.now() - self.startTime)
                self.dataAll["RGripRFingerForceRaw"][-1].append(raw)
                self.dataAll["RGripRFingerForce"][-1].append(
                    np.copy(self.RGripRFingerForce))
                self.dataAll["RGripRFingerPressure"][-1].append(pressure)
                self.dataAll["RGripRFingerPressureRaw"][-1].append(
                    pressure_raw)

    def accelerometerCallback(self, msg):
        samples = msg["samples"]
        raw = np.mean(samples, axis=0)
        if self.zeroing and self.accelMean is None:
            self.accelRecent.append(raw)
            if len(self.accelRecent) >= 20:
                self.accelMean = np.mean(self.accelRecent, axis=0)
        elif self.recording and self.accelMean is not None:
            now = self.clock.now() - self.startTime
            self.dataAll["accelerometerTime"][-1].extend([now] * len(samples))
            self.dataAll["accelerometerRaw"][-1].extend(samples)
            self.dataAll["accelerometer"][-1].extend(
                [np.array(s) - self.accelMean for s in samples])

    def contactmicCallback(self, msg):
        if self.zeroing and self.contactmicMean is None:
            self.contactmicRecent.append(msg[0])
            if len(self.contactmicRecent) >= 20:
                self.contactmicMean = np.mean(self.contactmicRecent)
        elif self.waitingForData and len(msg) != 1:  # not a late reading
            half = len(msg) // 2
            self.dataAll["contactmicTime"].append(msg[:half])
            self.dataAll["contactmicRaw"].append(msg[half:])
            self.dataAll["contactmic"].append(
                (np.array(msg[half:]) - self.contactmicMean).tolist())
            self.contactmicDataReceived = True

    def temperatureCallback(self, msg):
        if self.zeroing and self.temperatureMean is None:
            self.temperatureRecent.append(msg)
            if len(self.temperatureRecent) >= 20:
                self.temperatureMean = np.mean(self.temperatureRecent, axis=0)
        elif self.waitingForData and len(msg) != 2:  # not a late (raw, C)
            third = len(msg) // 3
            self.dataAll["temperatureTime"].append(msg[:third])
            raw = np.reshape(msg[third:], (third, 2))
            self.dataAll["temperatureRaw"].append(raw)
            self.dataAll["temperature"].append(raw - self.temperatureMean)
            self.temperatureDataReceived = True
        elif self.reheating:
            self.temperatureReheat = msg[-1]

    def zeroData(self, timeout=30.0):
        self.RGripRFingerForceMean = None
        self.RGripRFingerForceRecent = []
        self.accelMean = None
        self.accelRecent = []
        self.temperatureMean = None
        self.temperatureRecent = []
        self.contactmicMean = None
        self.contactmicRecent = []
        self.zeroing = True
        self.statePublisher("zeroing")
        deadline = self.clock.now() + timeout
        while (self.RGripRFingerForceMean is None or self.accelMean is None
               or self.temperatureMean is None or self.contactmicMean is None):
            if self.clock.now() > deadline:
                raise TimeoutError("zeroData: sensors not all reporting")
            self.clock.sleep(0.01)
        self.statePublisher("stop")
        self.zeroing = False
        if self.verbose:
            print("Data zeroed")

    def beginNewDataSequence(self):
        for key, value in self.dataAll.items():
            if "RGrip" in key or "accel" in key:
                value.append([])
        self.collisionTimeTemp = 10000
        self.collisionTimeForce = 10000
        self.zeroData()

    def saveData(self, iteration=-1, batch=-1):
        """Save the collected batch, or — with ``iteration >= 0`` — only the
        most recent poke sequence (collectdataPoke.py:218-229: single-
        sequence files drop the image keys and store the last list entry
        per stream, filename gains an ``_<iteration>`` segment)."""
        filename = os.path.join(
            self.dataDir,
            "newdata_%s_%dseqs%s%s" % (
                self.objectName, self.sequencesPerObject,
                "_%d" % iteration if iteration >= 0 else "",
                "_batchof%d_%d" % (self.saveBatchSize, batch)
                if batch >= 0 else ""),
        )
        if iteration < 0:
            data = self.dataAll
        else:
            data = {key: value[-1] for key, value in self.dataAll.items()
                    if key not in ("objectImage", "images")}
        os.makedirs(self.dataDir, exist_ok=True)
        with open(filename + ".pkl", "wb") as f:
            pickle.dump(data, f, pickle.HIGHEST_PROTOCOL)
        return filename + ".pkl"

    def reheat(self, target=55.0, tol=0.5, timeout=120.0):
        self.temperatureReheat = 0.0
        self.reheating = True
        self.statePublisher("zeroing")  # publisher streams readings (:236)
        deadline = self.clock.now() + timeout
        while abs(self.temperatureReheat - target) > tol:
            if self.clock.now() > deadline:
                break  # continue with a cooler fingertip rather than hang
            self.clock.sleep(0.5)
        self.statePublisher("stop")
        self.reheating = False
        if self.verbose:
            print("Temperature sensor reheated to:", self.temperatureReheat)

    # -- platter rotation (collectdataPoke.py:289-296, 381-390) --------------

    def _rotation_catchup(self):
        """Resume support: rotate the platter to where poke ``startCount``
        would have left it (collectdataPoke.py:289-296), so --startcount
        restarts land on un-poked surface."""
        sc, seq = self.startCount, self.sequencesPerObject
        quarter = max(1, int(seq / 4.0))  # seq < 4 would divide by zero
        if sc == 0 or self.neverrotate:
            return
        if (self.flat or self.rotateonce) and sc >= int(seq / 2.0):
            self.control.rotateGripperWrist(np.pi)
        elif self.quarterflat and sc >= quarter:
            self.control.rotateGripperWrist(np.pi / 2.0 * (sc // quarter))
        elif not self.flat and not self.quarterflat and not self.rotateonce:
            per = (2 * np.pi if not self.handle
                   else 2 * np.pi - np.pi / 2.0) / seq
            self.control.rotateGripperWrist(per * sc)

    def _rotate_after(self, i):
        """Per-poke rotation schedule (collectdataPoke.py:381-390)."""
        seq = self.sequencesPerObject
        if self.neverrotate:
            return
        if (self.flat or self.rotateonce) and i == int(seq / 2.0) - 1:
            self.control.rotateGripperWrist(np.pi)
        elif self.quarterflat and (i + 1) % max(1, int(seq / 4.0)) == 0:
            self.control.rotateGripperWrist(np.pi / 2.0)
        elif not self.flat and not self.quarterflat and not self.rotateonce:
            self.control.rotateGripperWrist(
                (2 * np.pi if not self.handle
                 else 2 * np.pi - np.pi / 2.0) / seq)

    def _maybe_pause(self):
        """Pause-on-keypress (collectdataPoke.py:301-305): a pending stdin
        line pauses until the operator presses enter again."""
        if self.pauseInput is not None:
            if self.pauseInput():
                input("Program paused. Press enter to continue")
            return
        import select
        import sys

        if not sys.stdin.isatty():
            return
        ii, _, _ = select.select([sys.stdin], [], [], 0.0001)
        if ii:
            sys.stdin.readline()
            input("Program paused. Press enter to continue")

    def _classify(self, i):
        """Classify poke ``i`` (the last of the batch dict) and publish the
        prediction on /semihaptics/prediction. A poke the classifier cannot
        window (a stream with no samples) is reported and collection goes
        on; any other error is a fault of the serving path (a CUDA, build
        or kernel launch error) and stops the run."""
        try:
            pred = self.classifier.classify_raw_poke(self.dataAll)
        except ShortWindowError as e:
            print("Poke %d classification failed: %s: %s"
                  % (i, type(e).__name__, e))
            return None
        self.predictions.append((i, pred))
        self.client.publish("/semihaptics/prediction", pred)
        if self.verbose:
            print("Iteration %d predicted material: %s" % (i, pred))
        return pred

    # -- poke loop (collectdataPoke.py:245-408) ------------------------------

    def _random_start_pos(self, rng):
        """Per-poke start-position randomization over the object's geometry
        (collectdataPoke.py:374-379): vertical pokes scatter over the
        object's top face (one-sided in x for curved surfaces), flat-platter
        pokes scatter across width and height, tall objects scatter along
        height only."""
        base = np.copy(self.initRightPos)
        if self.vertical:
            dx = (rng.uniform(-self.width / 2.0, self.width / 2.0)
                  if not self.curvedsurface else rng.uniform(0, self.width))
            return base + np.array([dx, rng.uniform(-self.length / 2.0,
                                                    self.length / 2.0), 0.0])
        if self.flat or self.quarterflat:
            return base + np.array(
                [rng.uniform(-self.width / 2.0, self.width / 2.0), 0.0,
                 rng.uniform(-0.01, self.height - 0.01)])
        if self.height > 0:
            return base + np.array(
                [0.0, 0.0, rng.uniform(-0.01, self.height - 0.01)])
        return base

    def performInteraction(self, init_right_pos=None, init_right_rpy=None,
                           rng=None):
        rng = rng or np.random
        if init_right_pos is not None:  # test/override hook
            self.initRightPos = np.array(init_right_pos, float)
        if init_right_rpy is not None:
            self.initRightRPY = np.array(init_right_rpy, float)
        start_pos = np.copy(self.initRightPos)
        self.control.moveGripperTo(start_pos, self.initRightRPY, timeout=0.5,
                                   wait=True, rightArm=True)
        self.control.moveGripperTo(self.initLeftPos, rightArm=False)
        if self.control.world is not None:
            # the object surface is anchored to the NOMINAL start: per-poke
            # randomization moves the start across the surface, not the
            # surface itself
            self.control.world.set_start(start_pos)

        self.reheat()
        self._rotation_catchup()
        if self.captureImages:
            # one object photo per interaction (collectdataPoke.py:276);
            # None when no camera publisher is on the bus — the key is
            # present either way, like the reference's saved schema
            self.dataAll["objectImage"] = self.grabImage()
        if self.verbose:
            print("Press enter at any point to pause the program")
        index = 2 if self.vertical else 1
        # poke travel grows with the object's extent along the poke axis
        # (collectdataPoke.py:320: 0.1+length horizontal, 0.1+height down)
        axis_delta = np.zeros(3)
        axis_delta[index] = (self.pokeDistance + self.length
                             if not self.vertical
                             else -(self.pokeDistance + self.height))
        saved = []

        i = self.startCount
        for i in range(self.startCount, self.sequencesPerObject):
            self._maybe_pause()
            self.beginNewDataSequence()
            motiontime = rng.uniform(1.5, 2.5)
            self.startTime = self.clock.now()
            self.control.moveGripperTo(start_pos + axis_delta,
                                       self.initRightRPY,
                                       timeout=motiontime, wait=False,
                                       rightArm=True)
            self.recording = True
            self.statePublisher("start")

            # spin until contact or timeout (:316,329-342). endCriteria also
            # stops when the gripper closes to within 4 cm of the left
            # gripper along the poke axis (:316,331): a soft object that
            # never crosses 1 N ends on position, not the 7 s timeout.
            while True:
                force = self.RGripRFingerForce
                right_pos, _ = self.control.getGripperPosition(rightArm=True)
                if (force[3] > 1 or force[4] > 1
                        or abs(right_pos[index]
                               - self.initLeftPos[index]) < 0.04
                        or self.collisionTimeTemp != 10000
                        or self.clock.now() - self.startTime > 7):
                    break
                self.clock.sleep(1.0 / self.hz)
            # small settle push past the stop point (:333-337)
            push = np.zeros(3)
            push[index] = 0.01 if not self.vertical else -0.01
            self.control.moveGripperTo(right_pos + push, self.initRightRPY,
                                       timeout=0.5, wait=False, rightArm=True)

            self.statePublisher("contact")
            self.collisionTimeForce = self.clock.now() - self.startTime

            # 4 s contact dwell (:345-347)
            grasp_end = self.clock.now() + 4.0
            while self.clock.now() < grasp_end:
                self.clock.sleep(1.0 / self.hz)

            # stop + bulk replay handshake (:350-359)
            self.waitingForData = True
            self.statePublisher("stop")
            self.recording = False
            deadline = self.clock.now() + 30.0
            while not (self.contactmicDataReceived
                       and self.temperatureDataReceived):
                if self.clock.now() > deadline:
                    raise TimeoutError("bulk sensor replay not received")
                self.clock.sleep(0.001)
            self.contactmicDataReceived = False
            self.temperatureDataReceived = False
            self.waitingForData = False

            self.dataAll["collisionTime"].append(
                min(self.collisionTimeForce, self.collisionTimeTemp))
            if self.perPokeImages:
                # per-iteration photo (collectdataPoke.py:366)
                self.dataAll["images"].append(self.grabImage())
            if self.verbose:
                print("Iteration %d collected, collision times:" % i,
                      (self.collisionTimeForce, self.collisionTimeTemp))
            if self.classifier is not None:
                self._classify(i)

            # retreat to a freshly randomized start over the object's
            # geometry, rotate the platter, and reheat (:374-399)
            start_pos = self._random_start_pos(rng)
            self.control.moveGripperTo(start_pos, self.initRightRPY,
                                       timeout=1.0, wait=True, rightArm=True)
            self._rotate_after(i)
            if (i + 1) % self.saveBatchSize == 0:
                saved.append(self.saveData(batch=(i + 1) // self.saveBatchSize))
                self.resetData()
                if self.captureImages:
                    # resetData wipes objectImage; re-grab so every batch
                    # file carries the interaction's object photo
                    self.dataAll["objectImage"] = self.grabImage()
            self.reheat()

        if (i + 1) % self.saveBatchSize != 0:
            saved.append(self.saveData(batch=(i + 1) // self.saveBatchSize))
        return saved
