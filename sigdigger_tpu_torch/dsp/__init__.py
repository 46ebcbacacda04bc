"""DSP modules of the port (counterpart of ``sigdigger_tpu/dsp``): the
host-side design helpers (numpy, float64-built: ``filters``, ``window``,
``pll``) and the class path's streaming stages on torch tensors
(``ncqo``, ``quad``, ``filters``' FIR application, ``resample``,
``agc``, ``spectrum``, ``channelizer``), with the analog TV processor
(``tv``)."""
