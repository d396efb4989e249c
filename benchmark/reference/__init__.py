"""Plain reference of what the benchmark's cells serve: the PQMF bank's
design and its two filterbank forms (``bank.py``) and the flagship's
per-band pitch shift with its crossfade (``pitch_shift.py``).

Plain ``torch`` and NumPy/SciPy, float32 with TF32 off (float64 for the
design), written from the published algorithm (acids-ircam RAVE's
``pqmf.py`` and the reference pitch shifter's wrapper). It imports nothing
of ``pqmf_tpu_torch`` nor of the JAX package, and takes nothing the program
made: it designs its own bank from the attenuation and the band count.

``tf32=True`` everywhere is the control: the same computation with every
operand of a convolution and of a DFT rounded to TF32 (10 mantissa bits,
nearest even), as the card's TF32 tensor cores take them.
"""
