"""Matplotlib renderers for the analytic envs (counterpart of
``prob_mbrl_tpu/envs/rendering.py``).

The reference ships pyglet viewers with ghost trails
(`prob_mbrl/envs/cartpole/env.py:174-248` and siblings). This viewer needs
only matplotlib, imported when a viewer is made: headless
(``mode='rgb_array'`` returns an RGB numpy array under any backend) or
interactive (``mode='human'`` updates a live figure when the backend
supports it). Each env contributes a ``scene(model, state)``, a dict of line
segments, circles, boxes and polygons in world coordinates, and the viewer
draws the current scene over an alpha-faded trail of recent ones (the
reference's ghost trail).
"""
import collections

import numpy as np


class MplViewer:
    """Persistent matplotlib figure drawing simple 2-D scenes.

    Args:
      xlim/ylim: world-coordinate bounds.
      trail: number of past scenes kept as alpha-faded ghosts.
    """

    def __init__(self, xlim=(-2.5, 2.5), ylim=(-1.5, 1.5), trail=8):
        import matplotlib
        import matplotlib.pyplot as plt
        self._plt = plt
        self._interactive = matplotlib.get_backend().lower() not in (
            'agg', 'pdf', 'svg', 'ps', 'template')
        self.fig, self.ax = plt.subplots(figsize=(6, 4))
        self.ax.set_xlim(*xlim)
        self.ax.set_ylim(*ylim)
        self.ax.set_aspect('equal')
        self.ax.axhline(0.0, color='0.85', lw=1, zorder=0)
        self._trail = collections.deque(maxlen=trail)
        self._artists = []

    def render(self, scene, mode='human'):
        for a in self._artists:
            a.remove()
        self._artists = []
        n = len(self._trail)
        for i, ghost in enumerate(self._trail):
            alpha = 0.35 * (i + 1) / (n + 1)
            self._draw(ghost, alpha)
        self._draw(scene, 1.0)
        self._trail.append(scene)
        if mode == 'human' and self._interactive:
            self.fig.canvas.draw_idle()
            self._plt.pause(1e-3)
            return None
        return self._to_rgb()

    def _draw(self, scene, alpha):
        for (x0, y0, x1, y1) in scene.get('lines', ()):
            self._artists.extend(self.ax.plot(
                [x0, x1], [y0, y1], '-', lw=3, color='tab:blue',
                alpha=alpha, solid_capstyle='round'))
        for (x, y, r) in scene.get('circles', ()):
            c = self._plt.Circle((x, y), r, color='tab:red', alpha=alpha)
            self.ax.add_patch(c)
            self._artists.append(c)
        for (x, y, w, h) in scene.get('boxes', ()):
            b = self._plt.Rectangle((x - w / 2, y - h / 2), w, h,
                                    color='0.3', alpha=alpha)
            self.ax.add_patch(b)
            self._artists.append(b)
        for verts in scene.get('polys', ()):
            p = self._plt.Polygon(np.asarray(verts), closed=True,
                                  color='tab:purple', alpha=alpha)
            self.ax.add_patch(p)
            self._artists.append(p)

    def _to_rgb(self):
        self.fig.canvas.draw()
        buf = np.asarray(self.fig.canvas.buffer_rgba())
        return buf[..., :3].copy()

    def close(self):
        self._plt.close(self.fig)


# -- per-env scenes (world coordinates follow each env's reward geometry) ---

def cartpole_scene(model, state):
    """[x, x', theta, theta']; tip = (x + l sin, -l cos) (`cartpole.py:45`)."""
    x, th = float(state[0]), float(state[2])
    lp = model.lp
    tip = (x + lp * np.sin(th), -lp * np.cos(th))
    return dict(boxes=[(x, 0.0, 0.3, 0.12)],
                lines=[(x, 0.0, tip[0], tip[1])],
                circles=[(tip[0], tip[1], 0.05)])


def pendulum_scene(model, state):
    """[theta, theta']; tip = (l sin, -l cos) (`pendulum.py:33`)."""
    th = float(state[0])
    l = model.l  # noqa: E741
    tip = (l * np.sin(th), -l * np.cos(th))
    return dict(lines=[(0.0, 0.0, tip[0], tip[1])],
                circles=[(tip[0], tip[1], 0.07)])


def double_cartpole_scene(model, state):
    """[x, x', th1, th1', th2, th2']; joint chain with the reward's tip
    convention (`double_cartpole.py:61`: tip_x = x - l1 sin1 - l2 sin2)."""
    x, th1, th2 = float(state[0]), float(state[2]), float(state[4])
    l1, l2 = model.l1, model.l2
    j1 = (x - l1 * np.sin(th1), l1 * np.cos(th1))
    j2 = (j1[0] - l2 * np.sin(th2), j1[1] + l2 * np.cos(th2))
    return dict(boxes=[(x, 0.0, 0.3, 0.12)],
                lines=[(x, 0.0, j1[0], j1[1]),
                       (j1[0], j1[1], j2[0], j2[1])],
                circles=[(j2[0], j2[1], 0.05)])


def rendezvous_scene(model, state):
    """[p1(2), p2(2), v1(2), v2(2)]: two vehicles (`rendezvous.py:19-38`)."""
    p1, p2 = state[0:2], state[2:4]
    return dict(circles=[(float(p1[0]), float(p1[1]), 0.08),
                         (float(p2[0]), float(p2[1]), 0.08)],
                lines=[(float(p1[0]), float(p1[1]),
                        float(p2[0]), float(p2[1]))])
