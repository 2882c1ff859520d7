"""Application base (port of granite_tpu/app/application.py; reference
application/application.hpp:31).

The headless runner (app/headless.py) drives an application through
swapchain_updated and render_frame; a frame is an (H, W, 4) uint8 tensor
on the application's device, which a sink (PNG writer, video encoder)
consumes.  The scene viewer, the triangle demo (BASELINE config 1) and
the video player derive from this one.

`device` stays the torch.device every module reads `.type` from; the
frame ring and the named-interval stats (core/device.Device, the JAX
application's `device`) are the separate `hub`.
"""

from __future__ import annotations

import torch

from ..core.device import Device
from ..event.manager import EventManager


class Application:
    def __init__(self, device="cuda", frames_in_flight: int | None = None):
        """device: 'cuda' (raises without a card) or 'cpu';
        frames_in_flight: the size of the hub's frame ring (None:
        GRANITE_VULKAN_SWAPCHAIN_IMAGES, else 2)."""
        self.hub = Device(device, frames_in_flight)
        self.device = self.hub.backend.default_device
        self.event_manager = EventManager.get()
        self.width = 0
        self.height = 0

    @staticmethod
    def add_cli(parser) -> None:
        """The application's own command-line flags (none here)."""

    def swapchain_updated(self, width: int, height: int) -> None:
        """SwapchainParameterEvent analogue: re-bake graphs on resize."""
        self.width = width
        self.height = height

    def render_frame(self, frame_time: float,
                     elapsed_time: float) -> torch.Tensor:
        """Produce the frame: an (H, W, 4) uint8 tensor on the device."""
        raise NotImplementedError

    def post_frame(self) -> None:
        """Asset-streaming hook (Application::post_frame)."""

    def teardown(self) -> None:
        """Wait for every frame in flight."""
        self.hub.wait_idle()
