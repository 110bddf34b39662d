"""Audio-seconds of denoised input whose scores came back in the window, over the window's seconds."""


def read(run):
    return sum(r.audio_s for r in run.window if r.error is None) / run.window_s
