"""Box2D lunar lander, the host-side env (the port's own copy of
``prob_mbrl_tpu/envs/lunar_lander.py``; numpy and Box2D only).

The parameterized continuous lander of the reference
(`prob_mbrl/envs/lunar_lander.py:80-416`, itself a vendored gym Box2D env
with configurable leg spring torque and engine powers). Stepwise
contact-driven rewards and rigid-body collision keep it on the host, behind
the gym-style API the other envs expose (``apply_controller`` streams it).
The differentiable counterpart is ``envs.jax_lander``.

What it keeps of the reference (cites into its file):
  * parameterized ``leg_spring_torque`` / ``main_engine_power`` /
    ``side_engine_power`` (`lunar_lander.py:88-96`);
  * terrain: 11 chunks, uniform heights, 5 flattened helipad chunks at
    H/4, 3-point smoothing (`:147-162`);
  * lander body + two sprung legs with motorized revolute joints and the
    [0.4, 0.9] travel limits (`:196-228`);
  * continuous 2-dim action: main engine dead below 0, throttles 50..100%;
    side engines dead in |a| < 0.5 (`:111-115,268-306`);
  * engine impulses with per-step dispersion noise (`:262-321`);
  * observation normalization to the viewport/leg frame (`:325-335`);
  * potential-based shaping reward + fuel costs, terminal -100 on crash /
    out-of-view, +100 when the body falls asleep (`:337-357`).

It leaves out the reference's short-lived exhaust "particle" bodies
(`:234-252,285-290`): their collision mask limits them to the terrain, so
they never touch the lander, its legs or the contact logic and change
neither dynamics nor rewards.
"""
import dataclasses
import math

import numpy as np

import Box2D
from Box2D.b2 import (contactListener, edgeShape, fixtureDef, polygonShape,
                      revoluteJointDef)

from .base import Box

FPS = 50
SCALE = 30.0

VIEWPORT_W = 600
VIEWPORT_H = 400

# body / leg geometry in viewport pixels (divided by SCALE for world units)
LANDER_POLY = [(-14, 17), (-17, 0), (-17, -10), (17, -10), (17, 0), (14, 17)]
LEG_AWAY = 20
LEG_DOWN = 18
LEG_W, LEG_H = 2, 8
SIDE_ENGINE_HEIGHT = 14.0
SIDE_ENGINE_AWAY = 12.0

INITIAL_RANDOM = 1000.0  # magnitude of the random kick applied at reset

N_CHUNKS = 11  # terrain segments; the middle 5 are the flattened helipad


@dataclasses.dataclass(frozen=True)
class LanderParams:
    """The reference's tunable physics knobs (`lunar_lander.py:88-96`)."""
    main_engine_power: float = 13.0
    side_engine_power: float = 0.6
    leg_spring_torque: float = 40.0


class _ContactTracker(contactListener):
    """Flags body-ground contact (crash) and per-leg ground contact
    (`lunar_lander.py:58-77`)."""

    def __init__(self, env):
        contactListener.__init__(self)
        self.env = env

    def BeginContact(self, contact):
        bodies = (contact.fixtureA.body, contact.fixtureB.body)
        if self.env.lander in bodies:
            self.env.game_over = True
        for leg in self.env.legs:
            if leg in bodies:
                leg.ground_contact = True

    def EndContact(self, contact):
        for leg in self.env.legs:
            if leg in (contact.fixtureA.body, contact.fixtureB.body):
                leg.ground_contact = False


class LunarLander:
    """Continuous-control Box2D lunar lander with the gym API.

    Action: ``[main, side]`` in [-1, 1]^2. Main engine is off for
    ``main <= 0`` and throttles 50%..100% over (0, 1]; side engines are off
    for ``|side| < 0.5``, sign picks the engine (`lunar_lander.py:111-115`).
    Observation: 8-dim ``[x, y, vx, vy, angle, angular_vel, left_contact,
    right_contact]`` in the normalized helipad frame (`:325-335`).

    No ``reward_func`` attribute: rewards are stepwise and contact-driven
    (non-differentiable), so the learned-reward dynamics-model path applies
    — exactly the reference's situation for this env.
    """
    metadata = {'render.modes': [], 'video.frames_per_second': FPS}
    spec = None
    continuous = True

    observation_size = 8
    action_size = 2

    def __init__(self, leg_spring_torque=40.0, main_engine_power=13.0,
                 side_engine_power=0.6, device=None):
        # ``device`` is taken for the registry's signature and not used: the
        # physics stay on the host
        self.params = LanderParams(
            main_engine_power=float(main_engine_power),
            side_engine_power=float(side_engine_power),
            leg_spring_torque=float(leg_spring_torque))
        self.dt = 1.0 / FPS
        self.angle_dims = ()
        self.np_random = np.random.RandomState()

        self.world = Box2D.b2World()
        self.moon = None
        self.lander = None
        self.legs = []
        self.game_over = False
        self.prev_shaping = None
        self.helipad_y = None

        self.action_space = Box(-np.ones(2, np.float32),
                                np.ones(2, np.float32))
        self.observation_space = Box(-np.inf * np.ones(8, np.float32),
                                     np.inf * np.ones(8, np.float32))
        self.reset()

    # -- gym API -------------------------------------------------------------
    def seed(self, seed=None):
        self.np_random = np.random.RandomState(seed)
        return [seed]

    def _destroy(self):
        if self.moon is None:
            return
        self.world.contactListener = None
        for body in [self.moon, self.lander] + self.legs:
            self.world.DestroyBody(body)
        self.moon = self.lander = None
        self.legs = []

    def _build_terrain(self, W, H):
        """Random edge-chain terrain with a flat helipad (`:147-172`)."""
        heights = self.np_random.uniform(0, H / 2, size=(N_CHUNKS + 1,))
        xs = [W / (N_CHUNKS - 1) * i for i in range(N_CHUNKS)]
        mid = N_CHUNKS // 2
        self.helipad_x1 = xs[mid - 1]
        self.helipad_x2 = xs[mid + 1]
        self.helipad_y = H / 4
        heights[mid - 2:mid + 3] = self.helipad_y
        smooth = [0.33 * (heights[i - 1] + heights[i] + heights[i + 1])
                  for i in range(N_CHUNKS)]

        self.moon = self.world.CreateStaticBody(
            shapes=edgeShape(vertices=[(0, 0), (W, 0)]))
        for i in range(N_CHUNKS - 1):
            self.moon.CreateEdgeFixture(
                vertices=[(xs[i], smooth[i]), (xs[i + 1], smooth[i + 1])],
                density=0, friction=0.1)

    def _build_lander(self, W, H):
        """Lander body + sprung legs, kicked with a random force (`:177-228`)."""
        self.lander = self.world.CreateDynamicBody(
            position=(W / 2, H),
            angle=0.0,
            fixtures=fixtureDef(
                shape=polygonShape(
                    vertices=[(x / SCALE, y / SCALE) for x, y in LANDER_POLY]),
                density=5.0, friction=0.1, restitution=0.0,
                categoryBits=0x0010, maskBits=0x001))
        self.lander.ApplyForceToCenter(
            (self.np_random.uniform(-INITIAL_RANDOM, INITIAL_RANDOM),
             self.np_random.uniform(-INITIAL_RANDOM, INITIAL_RANDOM)), True)

        self.legs = []
        for side in (-1, +1):
            leg = self.world.CreateDynamicBody(
                position=(W / 2 - side * LEG_AWAY / SCALE, H),
                angle=side * 0.05,
                fixtures=fixtureDef(
                    shape=polygonShape(box=(LEG_W / SCALE, LEG_H / SCALE)),
                    density=1.0, restitution=0.0,
                    categoryBits=0x0020, maskBits=0x001))
            leg.ground_contact = False
            joint = revoluteJointDef(
                bodyA=self.lander, bodyB=leg,
                localAnchorA=(0, 0),
                localAnchorB=(side * LEG_AWAY / SCALE, LEG_DOWN / SCALE),
                enableMotor=True, enableLimit=True,
                maxMotorTorque=self.params.leg_spring_torque,
                motorSpeed=0.3 * side)
            # travel limits from the reference (`:221-226`)
            if side == -1:
                joint.lowerAngle, joint.upperAngle = 0.4, 0.9
            else:
                joint.lowerAngle, joint.upperAngle = -0.9, -0.4
            leg.joint = self.world.CreateJoint(joint)
            self.legs.append(leg)

    def reset(self):
        self._destroy()
        self._contact_tracker = _ContactTracker(self)  # keep a python ref
        self.world.contactListener = self._contact_tracker
        self.game_over = False
        self.prev_shaping = None

        W, H = VIEWPORT_W / SCALE, VIEWPORT_H / SCALE
        self._build_terrain(W, H)
        self._build_lander(W, H)
        # the reference settles the fresh world with one no-op step (`:232`)
        return self.step(np.zeros(2, np.float32))[0]

    # -- engines -------------------------------------------------------------
    def _fire_engines(self, action, tip, side, dispersion):
        """Apply the main/side engine impulses; returns (m_power, s_power)
        for the fuel costs (`:268-321`)."""
        # python floats throughout: this Box2D build rejects numpy scalars
        # in b2Vec2 conversions
        p = self.params
        m_power = 0.0
        if action[0] > 0.0:
            m_power = float(np.clip(action[0], 0.0, 1.0) + 1.0) * 0.5
            ox = tip[0] * (4 / SCALE + 2 * dispersion[0]) \
                + side[0] * dispersion[1]
            oy = -tip[1] * (4 / SCALE + 2 * dispersion[0]) \
                - side[1] * dispersion[1]
            at = (self.lander.position[0] + ox, self.lander.position[1] + oy)
            self.lander.ApplyLinearImpulse(
                (-ox * p.main_engine_power * m_power,
                 -oy * p.main_engine_power * m_power), at, True)

        s_power = 0.0
        if abs(action[1]) > 0.5:
            direction = float(np.sign(action[1]))
            s_power = float(np.clip(abs(action[1]), 0.5, 1.0))
            ox = tip[0] * dispersion[0] + side[0] * (
                3 * dispersion[1] + direction * SIDE_ENGINE_AWAY / SCALE)
            oy = -tip[1] * dispersion[0] - side[1] * (
                3 * dispersion[1] + direction * SIDE_ENGINE_AWAY / SCALE)
            at = (self.lander.position[0] + ox - tip[0] * 17 / SCALE,
                  self.lander.position[1] + oy
                  + tip[1] * SIDE_ENGINE_HEIGHT / SCALE)
            self.lander.ApplyLinearImpulse(
                (-ox * p.side_engine_power * s_power,
                 -oy * p.side_engine_power * s_power), at, True)
        return m_power, s_power

    # -- observation / reward ------------------------------------------------
    def _observe(self):
        """Normalized 8-dim state in the helipad frame (`:325-335`)."""
        pos, vel = self.lander.position, self.lander.linearVelocity
        half_w = VIEWPORT_W / SCALE / 2
        half_h = VIEWPORT_H / SCALE / 2
        return np.array([
            (pos.x - half_w) / half_w,
            (pos.y - (self.helipad_y + LEG_DOWN / SCALE)) / half_h,
            vel.x * half_w / FPS,
            vel.y * half_h / FPS,
            self.lander.angle,
            20.0 * self.lander.angularVelocity / FPS,
            1.0 if self.legs[0].ground_contact else 0.0,
            1.0 if self.legs[1].ground_contact else 0.0,
        ], dtype=np.float32)

    @staticmethod
    def _shaping(s):
        """Potential for the shaping reward (`:338-341`), in float64 like the
        reference's python-float math."""
        s = np.asarray(s, np.float64)
        return (-100 * np.sqrt(s[0] ** 2 + s[1] ** 2)
                - 100 * np.sqrt(s[2] ** 2 + s[3] ** 2)
                - 100 * abs(s[4]) + 10 * s[6] + 10 * s[7])

    def step(self, action):
        action = np.clip(np.asarray(action, np.float32).reshape(-1), -1, 1)

        angle = self.lander.angle
        tip = (math.sin(angle), math.cos(angle))
        side = (-tip[1], tip[0])
        dispersion = [self.np_random.uniform(-1.0, 1.0) / SCALE
                      for _ in range(2)]
        m_power, s_power = self._fire_engines(action, tip, side, dispersion)

        self.world.Step(1.0 / FPS, 6 * 30, 2 * 30)

        state = self._observe()
        shaping = self._shaping(state)
        reward = 0.0 if self.prev_shaping is None else \
            float(shaping - self.prev_shaping)
        self.prev_shaping = shaping
        reward -= m_power * 0.30 + s_power * 0.03  # fuel (`:347-348`)

        done = False
        if self.game_over or abs(state[0]) >= 1.0:
            done, reward = True, -100.0
        if not self.lander.awake:  # at rest: landed (`:354-356`)
            done, reward = True, +100.0
        return state, reward, done, {}

    def render(self, mode='human'):
        """Matplotlib render of the Box2D scene (counterpart of the
        reference's pyglet viewer, `lunar_lander.py:359-407`): terrain
        edges, the lander hull and both legs drawn from the live body
        transforms; helipad flags as markers."""
        if self.moon is None:
            raise RuntimeError('render() before reset()')
        if getattr(self, 'viewer', None) is None:
            from .rendering import MplViewer
            W, H = VIEWPORT_W / SCALE, VIEWPORT_H / SCALE
            self.viewer = MplViewer(xlim=(0, W), ylim=(0, H), trail=0)
        lines = []
        for fixture in self.moon.fixtures:
            v = fixture.shape.vertices
            if len(v) == 2:
                lines.append((v[0][0], v[0][1], v[1][0], v[1][1]))
        polys = []
        for body in [self.lander] + self.legs:
            for fixture in body.fixtures:
                polys.append([tuple(body.transform * p)
                              for p in fixture.shape.vertices])
        flags = [(self.helipad_x1, self.helipad_y, 0.15),
                 (self.helipad_x2, self.helipad_y, 0.15)]
        return self.viewer.render(
            dict(lines=lines, polys=polys, circles=flags), mode)

    def close(self):
        if getattr(self, 'viewer', None) is not None:
            self.viewer.close()
            self.viewer = None


class LunarLanderContinuous(LunarLander):
    continuous = True
