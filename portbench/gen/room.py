"""The room scene: a rolling-shutter clip of a camera that rotates and
translates in the near field, inside a textured box (a table top with
walls), rendered on the device. It is of the kind of the thesis's
"table" clip (handheld over a table, 60 fps), but no source gives that
clip's sizes: the box, the pitch, the translation's amplitudes and band
and the texture's scale are the configuration's own, assumed.

A configuration chooses it with `"model": "room"` in its `scene`
section; the harness then calls `bind(scene)`, whose result has the
interface of `synthclip` (`hero6_lens`, `trajectory_params`,
`gyro_log`, `render_frames`), and judges the clip by
`portbench/reference/room.py`. Keys of the `scene` section it reads:

- `box_m`: `[[x_lo, x_hi], [y_lo, y_hi], [z_lo, z_hi]]`, the walls, m,
  about the camera's mean centre; y points down (the table top is
  `y_hi`), z at the wall the camera faces (`z_hi`);
- `mount_pitch_deg`: the constant pitch of the camera, down;
- `translation_amp_m`: per axis, the sum of the amplitudes of the
  centre's 3 sinusoids, m, and `translation_hz`: their band;
- `texture_d_ref_m`: the texture's length scale, m.

Lens and exposure are synthclip's: `hero6_lens`, each row at its own
time f / fps + readout * row / height. The orientation is synthclip's
Euler-angle rotation of the seed after the mount pitch; a constant
rotation on the world side leaves the body rates as they are, and a
gyro senses no translation, so the gyro log is `synthclip.gyro_log`.
The centre's sinusoids come from the seed stream [seed, 4], which the
harness leaves alone ([seed, 1] draws the delay, [seed, 2] the order of
windows, [seed, 3, k] the problems' RANSAC seeds). The texture is
synthclip's 24-wave field of the world point X / d_ref, a solid texture,
continuous across the box's edges.

Plain torch and numpy; it imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.gen import synthclip

_F32 = torch.float32


class Room:
    """The room of one `scene` section, with synthclip's interface."""

    hero6_lens = staticmethod(synthclip.hero6_lens)
    gyro_log = staticmethod(synthclip.gyro_log)

    def __init__(self, scene: dict):
        self.box = tuple((float(lo), float(hi)) for lo, hi in scene["box_m"])
        self.pitch = float(np.deg2rad(scene["mount_pitch_deg"]))
        self.amp = np.asarray(scene["translation_amp_m"], np.float64)
        self.band = tuple(float(f) for f in scene["translation_hz"])
        self.d_ref = float(scene["texture_d_ref_m"])
        if len(self.box) != 3 or any(not lo < 0.0 < hi for lo, hi in self.box):
            raise ValueError(f"scene.box_m must hold the camera's mean centre: {self.box}")
        if self.amp.shape != (3,) or self.d_ref <= 0.0:
            raise ValueError("scene.translation_amp_m needs 3 amplitudes, texture_d_ref_m > 0")

    def trajectory_params(self, seed: int, n_modes: int = 3) -> dict:
        """The scene of `seed`: synthclip's rotation, the centre's
        sinusoids (freqs, phases, amps), each (3, n_modes), whose
        amplitudes sum to `translation_amp_m` an axis, and the box and
        the pitch the truth needs."""
        rng = np.random.default_rng([seed, 4])
        freqs = rng.uniform(*self.band, size=(3, n_modes))
        phases = rng.uniform(0, 2 * np.pi, size=(3, n_modes))
        w = rng.uniform(0.3, 1.0, size=(3, n_modes))
        amps = w / w.sum(axis=1, keepdims=True) * self.amp[:, None]
        return {"rotation": synthclip.trajectory_params(seed),
                "translation": (freqs, phases, amps),
                "pitch_rad": self.pitch, "box_m": self.box}

    def _centre(self, traj: dict, t: torch.Tensor) -> torch.Tensor:
        """(..., 3) C(t), float32."""
        freqs, phases, amps = traj["translation"]

        def c(x):
            return torch.as_tensor(x, dtype=_F32, device=t.device)

        return torch.stack([torch.sum(c(amps[i]) * torch.sin(c(2 * np.pi * freqs[i]) * t[..., None]
                                                             + c(phases[i])), dim=-1)
                            for i in range(3)], dim=-1)

    def render_frames(self, seed: int, indices, fps: float, width: int, height: int,
                      readout: float, device, lens=None) -> torch.Tensor:
        """Frames `indices` of the clip of `seed`: (len(indices), H, W)
        uint8 on `device`, row by row at f / fps + readout * row / height."""
        dev = torch.device(device)
        lens = lens or synthclip.hero6_lens(width, height, readout)
        cam_rays = synthclip.camera_rays(lens, width, height, dev)
        traj = self.trajectory_params(seed)
        angles_of = synthclip._euler_trajectory(seed)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        mount = torch.tensor([[1.0, 0.0, 0.0], [0.0, cp, sp], [0.0, -sp, cp]], dtype=_F32,
                             device=dev)
        lo = torch.tensor([b[0] for b in self.box], dtype=_F32, device=dev)
        hi = torch.tensor([b[1] for b in self.box], dtype=_F32, device=dev)
        out = torch.empty((len(indices), height, width), dtype=torch.uint8, device=dev)
        row_frac = np.arange(height) / height
        for i, f in enumerate(indices):
            row_times = torch.as_tensor(f / fps + readout * row_frac, dtype=_F32, device=dev)
            R = mount @ synthclip._euler_to_matrix(angles_of(row_times))  # (H, 3, 3)
            d = torch.einsum("hij,hwj->hwi", R, cam_rays)
            c = self._centre(traj, row_times)[:, None, :]  # (H, 1, 3)
            # the nearest wall ahead on each axis; an axis the ray runs
            # parallel to is never ahead
            wall = torch.where(d > 0, hi, lo)
            s = torch.where(d != 0, (wall - c) / torch.where(d != 0, d, 1.0), torch.inf)
            X = c + s.amin(dim=-1, keepdim=True) * d
            out[i] = synthclip._texture(X / self.d_ref, seed).to(torch.uint8)
        return out


def bind(scene: dict) -> Room:
    """The renderer and gyro log of a configuration's `scene` section."""
    return Room(scene)
