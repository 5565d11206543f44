from .synth import make_synth_images, SynthSpec  # noqa: F401
