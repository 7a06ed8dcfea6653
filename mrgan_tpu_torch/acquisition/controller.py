"""Simulated PR2 arm controller + fingertip sensor streams + contact physics.

Port of ``mrgan_tpu/acquisition/controller.py`` (a copy: it never touched
JAX); the gain profiles are the repository's ``datacollection/control/``
files, as there.

Replaces two reference components:

- datacollection/control/controller.py (C13): the Controller API used by the
  orchestrator — moveGripperTo / grip / rotateGripperWrist / lookAt /
  initJoints / getGripperPosition — reimplemented over a kinematic point
  model (linear interpolation to the goal over the commanded timeout,
  matching the joint-trajectory actionlib semantics the orchestrator relies
  on: non-blocking, queryable position);
- the physical world the PR2 provided: fingertip force/pressure raw taxel
  streams (/pressure/r_gripper_motor) and gripper accelerometer
  (/accelerometer/r_gripper_motor) topics, plus the thermal/acoustic contact
  coupling, driven into the C++ firmware sims via their X/R and B commands.

Material presets set the contact physics (thermal coupling, stiffness,
resonance) so different 'objects' produce distinguishable signals end-to-end.
"""

import os
import threading

import numpy as np

from .bus import BusClient

# (thermal coupling mK/s, stiffness N/mm-ish, resonance Hz, burst amp, decay)
MATERIALS = {
    "plastic": (120, 0.5, 900.0, 400.0, 60.0),
    "glass": (260, 0.9, 2400.0, 900.0, 25.0),
    "fabric": (40, 0.15, 300.0, 100.0, 150.0),
    "metal": (420, 1.0, 3600.0, 1100.0, 15.0),
    "wood": (100, 0.7, 600.0, 500.0, 80.0),
    "ceramic": (280, 0.95, 1800.0, 800.0, 30.0),
}

FORCE_PER_UNIT = 50.0     # raw counts per newton (stands in for PressureInfo)
TACTILE_AREA = 0.0003     # m^2 per taxel (pressure = F / area / 1000 kPa)
N_TAXELS = 22             # PR2 fingertip array size
FORCE_RATE = 50.0         # Hz
ACCEL_RATE = 100.0        # Hz

# -- arm-controller gain profiles (C17) --------------------------------------
# datacollection/control/pr2_arm_controllers_{grasp,original}.yaml mirror the
# reference's stiff poking gains (its grasp yaml :13-19) and the factory
# defaults (the commented block inside the same file, :21-27). The sim arm
# consumes them as a Cartesian servo: joint p-gains set an effective
# end-effector stiffness (the spring the servo can exert against contact),
# d/p sets the tracking lag. i/i_clamp (steady-state trim on the real robot)
# are parsed but not modeled — the kinematic arm has no gravity sag.

_CONTROL_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "datacollection", "control")
GAIN_PROFILES = {
    "grasp": "pr2_arm_controllers_grasp.yaml",
    "original": "pr2_arm_controllers_original.yaml",
    "factory": "pr2_arm_controllers_original.yaml",
    "active": "pr2_arm_controllers_active.yaml",  # change_gains_pr2.sh symlink
}
# Cartesian stiffness per unit of mean joint p-gain. Calibrated so the grasp
# profile tracks near-kinematically against the stiffest sim material
# (pen_actual/pen_commanded ~ 0.95 on metal) while the factory profile
# visibly complies (~0.44): stiff gains push through contact, factory gains
# stall against it — the reason the reference swaps gains for poking.
GAIN_TO_CART_STIFFNESS = 8.0


def _yaml_scalar(v):
    try:
        return float(v)
    except ValueError:
        return v


def parse_simple_yaml(text):
    """Minimal YAML-subset parser for the controller gain files: nested maps
    by indentation, inline {k: v, ...} maps, float/str scalars. Avoids a
    pyyaml dependency for two 30-line config files."""
    root = {}
    stack = [(-1, root)]
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.strip().partition(":")
        val = val.strip()
        while len(stack) > 1 and indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if not val:
            child = {}
            parent[key] = child
            stack.append((indent, child))
        elif val.startswith("{"):
            inner = {}
            for part in val.strip("{}").split(","):
                k, _, v = part.partition(":")
                inner[k.strip()] = _yaml_scalar(v.strip())
            parent[key] = inner
        else:
            parent[key] = _yaml_scalar(val)
    return root


def load_gain_profile(profile="grasp"):
    """Load a gain profile by name ('grasp', 'original'/'factory', 'active' =
    the change_gains_pr2.sh symlink) or by path. 'active' falls back to the
    grasp profile when the symlink has not been created."""
    if isinstance(profile, dict):
        return profile
    path = os.path.join(_CONTROL_DIR, GAIN_PROFILES.get(profile, profile))
    if not os.path.exists(path) and profile == "active":
        path = os.path.join(_CONTROL_DIR, GAIN_PROFILES["grasp"])
    with open(path) as f:
        return parse_simple_yaml(f.read())


def cartesian_servo_params(profile):
    """(k_servo N/m-ish, tracking-lag tau s) from a gain profile dict."""
    gains = profile["r_arm_controller"]["gains"]
    ps = [g["p"] for g in gains.values()]
    ds = [g["d"] for g in gains.values()]
    mean_p = float(np.mean(ps))
    k_servo = GAIN_TO_CART_STIFFNESS * mean_p
    tau = float(np.mean(ds)) / mean_p
    return k_servo, tau


class SimWorld(threading.Thread):
    """Publishes PR2 sensor streams and couples contact into the firmware
    sims. The gripper's poke axis is y (index 1) for horizontal pokes or z
    (index 2) for vertical, like the reference's endCriteria index."""

    def __init__(self, bus_address, clock, thermal_dev, mic_dev,
                 material="plastic", surface_offset=0.05, axis=1, seed=0):
        # surface_offset places the object surface 5 cm into the poke travel:
        # stiff materials cross 1 N before the orchestrator's position stop
        # (|pos - initLeftPos| < 0.04, collectdataPoke.py:316) while soft
        # ones (fabric: ~17 mm penetration to reach 1 N) end on position,
        # matching the real rig's geometry where the object face sits
        # more than 4 cm proud of the left gripper.
        super().__init__(daemon=True)
        self.clock = clock
        self.client = BusClient(bus_address)
        self.thermal_dev = thermal_dev
        self.mic_dev = mic_dev
        self.material = material
        self.axis = axis
        self.surface = None  # set on first gripper position report
        self.surface_offset = surface_offset
        self.gripper_pos = np.zeros(3)
        self.in_contact = False
        self.rng = np.random.RandomState(seed)
        self._running = True
        self._lock = threading.Lock()

    def set_start(self, pos):
        """Anchor the object surface relative to the poke start position."""
        with self._lock:
            self.gripper_pos = np.array(pos, float)
            direction = 1.0 if self.axis == 1 else -1.0
            self.surface = pos[self.axis] + direction * self.surface_offset

    def update_gripper(self, pos):
        with self._lock:
            self.gripper_pos = np.array(pos, float)

    def _penetration(self):
        if self.surface is None:
            return 0.0
        if self.axis == 1:
            return max(0.0, self.gripper_pos[1] - self.surface)
        return max(0.0, self.surface - self.gripper_pos[2])

    def contact_stiffness(self):
        """dF/d(penetration) of the staged material (force model in run())."""
        return MATERIALS[self.material][1] * 400.0

    def project_compliant(self, pos, k_servo):
        """Quasi-static servo-vs-contact equilibrium: a commanded position
        ``pos`` penetrating the surface yields an ACTUAL penetration of
        pen * k_servo / (k_servo + k_obj) — the servo spring (from the
        active gain profile) in series with the contact spring. Stiff grasp
        gains push essentially through; factory gains visibly stall."""
        with self._lock:
            surface = self.surface
        if surface is None:
            return pos
        k_obj = self.contact_stiffness()
        ratio = k_servo / (k_servo + k_obj)
        pos = np.array(pos, float)
        if self.axis == 1:
            pen = pos[1] - surface
            if pen > 0.0:
                pos[1] = surface + pen * ratio
        else:
            pen = surface - pos[2]
            if pen > 0.0:
                pos[2] = surface - pen * ratio
        return pos

    def run(self):
        coupling, stiffness, freq, amp, decay = MATERIALS[self.material]
        force_period = 1.0 / FORCE_RATE
        accel_period = 1.0 / ACCEL_RATE
        next_force = next_accel = self.clock.now()
        while self._running:
            now = self.clock.now()
            pen = self._penetration()
            contact = pen > 0.0
            if contact and not self.in_contact:
                self.thermal_dev.write(f"X {int(coupling)}")
                jitter = self.rng.uniform(0.95, 1.05)
                self.mic_dev.write(f"B {freq * jitter} {amp} {decay}")
                self.in_contact = True
            elif not contact and self.in_contact:
                self.thermal_dev.write("R")
                self.in_contact = False

            if now >= next_force:
                raw = 1700.0 + 3.0 * self.rng.randn(N_TAXELS)
                force_n = stiffness * pen * 400.0
                raw[3] += force_n * FORCE_PER_UNIT
                raw[4] += 0.8 * force_n * FORCE_PER_UNIT
                self.client.publish("/pressure/r_gripper_motor",
                                    {"r_finger_tip": raw.tolist()})
                next_force += force_period
            if now >= next_accel:
                base = 0.02 * self.rng.randn(3, 3)
                if contact and pen < 0.004:
                    base += self.rng.randn(3, 3) * 2.0  # impact transient
                self.client.publish(
                    "/accelerometer/r_gripper_motor",
                    {"samples": base.tolist()},
                )
                next_accel += accel_period
            self.clock.sleep(min(force_period, accel_period) / 4.0)

    def stop(self):
        self._running = False


class SimController:
    """control/controller.py API over a kinematic point gripper."""

    def __init__(self, frame="torso_lift_link", vertical_movement=False,
                 world=None, clock=None, gain_profile="active"):
        self.frame = frame
        self.vertical = vertical_movement
        self.world = world
        self.clock = clock
        self.right_pos = np.zeros(3)
        self.right_rpy = np.zeros(3)
        self.left_pos = np.zeros(3)
        self.left_rpy = np.zeros(3)
        self.wrist_angle = 0.0
        self._movers = []
        self._goal_gen = 0  # actionlib semantics: a new goal preempts
        self.set_gains(gain_profile)

    def set_gains(self, profile):
        """Swap the arm gain profile (the change_gains_pr2.sh operation, C17):
        name, path, or parsed dict. Sets the Cartesian servo stiffness (how
        hard the arm pushes against contact) and tracking lag."""
        self.gain_profile = load_gain_profile(profile)
        self.servo_k, self.servo_tau = cartesian_servo_params(
            self.gain_profile)

    # -- motion ------------------------------------------------------------
    def moveGripperTo(self, position, orientation=None, timeout=4.0,
                      useInitGuess=False, wait=False, rightArm=True):
        """Linear-interpolated setpoint to the goal over ``timeout``
        sim-seconds, tracked by the gain-profile servo, on a background
        thread (actionlib-goal semantics: non-blocking unless wait=True;
        controller.py:105-153).

        The servo model is where the C17 gain profiles act: the commanded
        setpoint is followed with first-order lag ``servo_tau`` (= mean d/p
        of the active profile), and contact compliance is the quasi-static
        equilibrium of the profile's Cartesian stiffness against the
        object's (SimWorld.project_compliant) — so the factory profile's
        force traces rise later and plateau visibly lower than the stiff
        grasp profile's, the dynamics the reference swapped gains for."""
        position = np.array(position, float)
        if not rightArm:
            self.left_pos = position
            if orientation is not None:
                self.left_rpy = np.array(orientation, float)
            return

        start = np.copy(self.right_pos)
        t0 = self.clock.now()
        self._goal_gen += 1
        gen = self._goal_gen

        def mover():
            act = np.copy(start)
            last = t0
            while self._goal_gen == gen:  # preempted by a newer goal
                now = self.clock.now()
                f = min((now - t0) / max(timeout, 1e-6), 1.0)
                setp = start + f * (position - start)
                dt = max(now - last, 1e-9)
                last = now
                act[:] = act + (1.0 - np.exp(-dt / max(self.servo_tau, 1e-6))) \
                    * (setp - act)
                pos_out = act
                if self.world is not None:
                    pos_out = self.world.project_compliant(act, self.servo_k)
                self.right_pos = np.array(pos_out, float)
                if self.world is not None:
                    self.world.update_gripper(self.right_pos)
                if f >= 1.0 and (
                        float(np.max(np.abs(setp - act))) < 1e-4
                        or now - t0 > timeout + 8 * self.servo_tau):
                    return
                self.clock.sleep(0.002)

        th = threading.Thread(target=mover, daemon=True)
        th.start()
        self._movers.append(th)
        if orientation is not None:
            self.right_rpy = np.array(orientation, float)
        if wait:
            th.join()

    def getGripperPosition(self, rightArm=True):
        if rightArm:
            return np.copy(self.right_pos), np.copy(self.right_rpy)
        return np.copy(self.left_pos), np.copy(self.left_rpy)

    # -- auxiliary API (logged no-ops on the kinematic model) ---------------
    def grip(self, openGripper=False, maxEffort=20.0, rightArm=True,
             miniOpen=False):
        pass

    def rotateGripperWrist(self, angle):
        self.wrist_angle = (self.wrist_angle + angle) % (2 * np.pi)

    def lookAt(self, position):
        pass

    def initJoints(self):
        pass

    def printJointStates(self):
        pass
