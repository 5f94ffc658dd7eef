"""Host milliseconds a UNet eval inside its spatial transformers: the
recorded `unet.spatial` spans' durations (models/unet3d `UNetModel._run`)
over the recorded `unet` spans of the profiled slice."""

from program_spans import host_ms


def read(record):
    return host_ms(record, ("unet.spatial",), "unet")
