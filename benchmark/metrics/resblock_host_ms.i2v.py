"""Host milliseconds a UNet eval inside its ResBlocks: the recorded
`unet.resblock` spans' durations (models/unet3d `UNetModel._run`) over
the recorded `unet` spans (`UNetModel.forward`) of the profiled slice."""

from program_spans import host_ms


def read(record):
    return host_ms(record, ("unet.resblock",), "unet")
