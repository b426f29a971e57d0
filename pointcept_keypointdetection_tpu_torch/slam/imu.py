"""IMU propagation between scans: the counterpart of ``pointcept_keypointdetection_tpu/slam/imu.py``.

State: rotation, velocity, position, gyro and accelerometer biases;
midpoint integration over a padded window of samples (dt = 0 pads), one
sample at a time on the state's device (JAX scans the same step).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from . import se3

GRAVITY = (0.0, 0.0, -9.81)


class ImuState(NamedTuple):
    R: torch.Tensor  # [3, 3] world_R_body
    v: torch.Tensor  # [3] world velocity
    p: torch.Tensor  # [3] world position
    bg: torch.Tensor  # [3] gyro bias
    ba: torch.Tensor  # [3] accel bias

    @staticmethod
    def identity(device: Union[str, torch.device] = "cuda") -> "ImuState":
        zero = torch.zeros(3, device=device)
        return ImuState(R=torch.eye(3, device=device), v=zero, p=zero, bg=zero, ba=zero)


def propagate(state: ImuState, gyro: torch.Tensor, accel: torch.Tensor, dt: torch.Tensor) -> ImuState:
    """Midpoint-integrate a window: gyro [T, 3] and accel [T, 3] body rates and accelerations, dt [T]
    (`imu.py:38-56`)."""
    gravity = torch.tensor(GRAVITY, dtype=state.R.dtype, device=state.R.device)
    s = state
    for w, a, h in zip(gyro, accel, dt):
        w = w - s.bg
        a = a - s.ba
        dR = se3.so3_exp(w * h)
        R_mid = s.R @ se3.so3_exp(w * h * 0.5)
        acc_w = (R_mid @ a) + gravity
        v_new = s.v + acc_w * h
        p_new = s.p + s.v * h + 0.5 * acc_w * h * h
        s = s._replace(R=s.R @ dR, v=v_new, p=p_new)
    return s


def pose_prior(state: ImuState):
    """(R, t) prior for registration from the propagated state."""
    return state.R, state.p
