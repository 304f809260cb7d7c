"""Data-model constants of the Taijing-3-class dual-CMOS push-broom camera
that the port uses.

Copied from ``opticalimageprocessor_tpu/constants.py`` (the reference's
compile-time knobs, ``oipshared.h:27-64``); the values must stay equal to
the JAX package's (tests/test_torch_host_io.py holds them so).
"""

# Raster geometry (oipshared.h:27-32)
BYTES_PER_PIXEL = 2                  # uint16, little endian
PIXELS_PER_LINE = 12288              # PAN detector width
MSS_BANDS = 4

# Inter-band correlation defaults (oipshared.h:33-39)
CORRELATION_LINES = 16000
IBCV_DEF_THRESHOLD = 0.4             # minimum phase-correlation response
IBCV_MIN_COUNT = 5                   # minimum valid samples before polyfit
IBCV_DEF_SECTIONS = 5
IBCV_DEF_SLICES = 10
IBCV_MIN_SLICES = 8

# Inter-band pixel alignment defaults (oipshared.h:41-46)
IBPA_DEFAULT_LINEOFFSET = 0
IBPA_DEFAULT_BATCHLINES = 20000
IBPA_DEFAULT_LINEOVERLAP = 520
IBPA_MAX_LINEOVERLAP = 3000
IBPA_MIN_PROCESSLINES = 1500

# OpenCV-remap section rows honoured by the reference (imageop.h:19-20)
REMAP_SECTION_ROWS = 30000

# CMOS stitching defaults (oipshared.h:48-54)
STT_DEF_SECTIONS = 10
STT_DEF_SECLINES = 16000
STT_DEF_OVERLAPPX = 200
STT_DEF_PHCTHRHLD = 0.4
STT_DEF_MAXDELTAY = 0.0
STT_DEF_EDGECOLS = 0

# File-name stem-extension conventions (oipshared.h:56-64)
PRESTT_STEM_EXT = ".PRESTT"
RRC_STEM_EXT = ".RRC"
IBPA_STEM_EXT = ".ALIGNED"
TIFF_FILE_EXT = ".TIFF"
RAW_FILE_EXT = ".RAW"
AUX_FILE_EXT = ".AUX"
STEM_EXT_PAN = ".PAN"
STEM_EXT_MSS = ".MSS"
