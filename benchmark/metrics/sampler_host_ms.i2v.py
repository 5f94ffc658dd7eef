"""Host milliseconds a DDIM step in the sampler's own work: the recorded
`ddim.guidance` (CFG combine, rescale) and `ddim.update` (v to x0, dynamic
rescale, noise, new x) spans' durations (diffusion/ddim `ddim_sample`) over
the recorded `ddim.update` spans of the profiled slice."""

from program_spans import host_ms


def read(record):
    return host_ms(record, ("ddim.guidance", "ddim.update"), "ddim.update")
