"""WavPack format constants.

Semantics follow the reference decoder's flag/ID definitions
(reference: Defines.cs:18-156); values are part of the on-disk WavPack 4/5
format, not implementation choices.
"""

SAMPLE_BUFFER_SIZE = 4096

FALSE, TRUE = 0, 1

# open() flags
OPEN_2CH_MAX = 0x8
# extension beyond the reference: attempt to open the sibling `.wvc`
# correction file (main path + "c", libwavpack's convention and flag
# value) and decode hybrid blocks losslessly. The reference parses the
# wvc bitstream item (UnpackUtils.cs:93-108) but notes "this function
# will not handle 'correction' files" (WavPackUtils.cs:31)
OPEN_WVC = 0x1
# extension beyond the reference: decode every stream of a multichannel
# segment (the reference refuses >2ch without OPEN_2CH_MAX and then plays
# only the first stream, WavPackUtils.cs:100-112)
OPEN_ALL_CHANNELS = 0x10000

# 32-bit block header "flags" bitfield (Defines.cs:28-101)
BYTES_STORED = 3            # 1-4 bytes/sample
MONO_FLAG = 4
HYBRID_FLAG = 8
JOINT_STEREO = 0x10
CROSS_DECORR = 0x20
HYBRID_SHAPE = 0x40
FLOAT_DATA = 0x80
INT32_DATA = 0x100
HYBRID_BITRATE = 0x200
HYBRID_BALANCE = 0x400
INITIAL_BLOCK = 0x800
FINAL_BLOCK = 0x1000
SHIFT_LSB = 13
SHIFT_MASK = 0x1F << SHIFT_LSB
MAG_LSB = 18
MAG_MASK = 0x1F << MAG_LSB
SRATE_LSB = 23
SRATE_MASK = 0xF << SRATE_LSB
FALSE_STEREO = 0x40000000
DSD_FLAG = 0x80000000
MONO_DATA = MONO_FLAG | FALSE_STEREO

MIN_STREAM_VERS = 0x402
MAX_STREAM_VERS = 0x410

# Engine hardening cap on a block's claimed sample count (no reference
# analog: the C# decoder streams sample-serially, so an absurd
# block_samples from a corrupted header only wastes its time — this
# block-parallel engine would materialize (T, lanes) device arrays of
# that size. Real encoders stay orders of magnitude below this (the
# WavPack format caps blocks at 131072 samples); anything above is a
# corrupt header and is concealed like one. See PARITY.md.
MAX_BLOCK_SAMPLES = 1 << 21

# metadata sub-block IDs (Defines.cs:50-83)
ID_UNIQUE = 0x3F
ID_OPTIONAL_DATA = 0x20
ID_ODD_SIZE = 0x40
ID_LARGE = 0x80

ID_DUMMY = 0x0
ID_ENCODER_INFO = 0x1
ID_DECORR_TERMS = 0x2
ID_DECORR_WEIGHTS = 0x3
ID_DECORR_SAMPLES = 0x4
ID_ENTROPY_VARS = 0x5
ID_HYBRID_PROFILE = 0x6
ID_SHAPING_WEIGHTS = 0x7
ID_FLOAT_INFO = 0x8
ID_INT32_INFO = 0x9
ID_WV_BITSTREAM = 0xA
ID_WVC_BITSTREAM = 0xB
ID_WVX_BITSTREAM = 0xC
ID_CHANNEL_INFO = 0xD
ID_DSD_BLOCK = 0xE

ID_RIFF_HEADER = ID_OPTIONAL_DATA | 0x1
ID_RIFF_TRAILER = ID_OPTIONAL_DATA | 0x2
ID_ALT_HEADER = ID_OPTIONAL_DATA | 0x3
ID_ALT_TRAILER = ID_OPTIONAL_DATA | 0x4
ID_CONFIG_BLOCK = ID_OPTIONAL_DATA | 0x5
ID_MD5_CHECKSUM = ID_OPTIONAL_DATA | 0x6
ID_SAMPLE_RATE = ID_OPTIONAL_DATA | 0x7
ID_ALT_EXTENSION = ID_OPTIONAL_DATA | 0x8
ID_NEW_CONFIG_BLOCK = ID_OPTIONAL_DATA | 0xA
ID_WVX_NEW_BITSTREAM = ID_OPTIONAL_DATA | ID_WVX_BITSTREAM
ID_BLOCK_CHECKSUM = ID_OPTIONAL_DATA | 0xF

# float_flags (Defines.cs:96-101)
FLOAT_SHIFT_ONES = 1
FLOAT_SHIFT_SAME = 2
FLOAT_SHIFT_SENT = 4
FLOAT_ZEROS_SENT = 8
FLOAT_NEG_ZEROS = 0x10
FLOAT_EXCEPTIONS = 0x20

MAX_NTERMS = 16
MAX_TERM = 8

# CONFIG_* informational bits (Defines.cs:111-133)
CONFIG_BYTES_STORED = 3
CONFIG_MONO_FLAG = 4
CONFIG_HYBRID_FLAG = 8
CONFIG_JOINT_STEREO = 0x10
CONFIG_CROSS_DECORR = 0x20
CONFIG_HYBRID_SHAPE = 0x40
CONFIG_FLOAT_DATA = 0x80
CONFIG_FAST_FLAG = 0x200
CONFIG_HIGH_FLAG = 0x800
CONFIG_VERY_HIGH_FLAG = 0x1000
CONFIG_BITRATE_KBPS = 0x2000
CONFIG_AUTO_SHAPING = 0x4000
CONFIG_SHAPE_OVERRIDE = 0x8000
CONFIG_JOINT_OVERRIDE = 0x10000
CONFIG_CREATE_EXE = 0x40000
CONFIG_CREATE_WVC = 0x80000
CONFIG_OPTIMIZE_WVC = 0x100000
CONFIG_CALC_NOISE = 0x800000
CONFIG_LOSSY_MODE = 0x1000000
CONFIG_EXTRA_MODE = 0x2000000
CONFIG_SKIP_WVX = 0x4000000
CONFIG_MD5_CHECKSUM = 0x8000000
CONFIG_OPTIMIZE_MONO = 0x80000000

# WavpackGetMode() mask bits (Defines.cs:135-145)
MODE_WVC = 0x1
MODE_LOSSLESS = 0x2
MODE_HYBRID = 0x4
MODE_FLOAT = 0x8
MODE_VALID_TAG = 0x10
MODE_HIGH = 0x20
MODE_FAST = 0x40
MODE_EXTRA = 0x80
MODE_VERY_HIGH = 0x400
MODE_XMODE = 0x7000
MODE_DSD = 0x10000
# extension: set when the file stores an ID_MD5_CHECKSUM digest. The C#
# reference defines no such bit (it skips the sub-block); the value
# matches libwavpack's MODE_MD5, which is unused by the reference's
# constants so the extension cannot collide.
MODE_MD5 = 0x200

SAMPLE_RATES = (6000, 8000, 9600, 11025, 12000, 16000, 22050, 24000,
                32000, 44100, 48000, 64000, 88200, 96000, 192000)

# entropy coder time constants (WordsUtils.cs:17-28)
LIMIT_ONES = 16
SLS = 8
SLO = 1 << (SLS - 1)
DIV0, DIV1, DIV2 = 128, 64, 32

# file formats (Defines.cs eFileFormat); an IntEnum so
# WavpackGetFileFormat returns an enum like the reference while staying
# comparable to the plain FORMAT_* ints
import enum as _enum


class FileFormat(_enum.IntEnum):
    WAV = 0
    W64 = 1
    CAF = 2
    DFF = 3
    DSF = 4
    AIF = 5


FORMAT_WAV, FORMAT_W64, FORMAT_CAF, FORMAT_DFF, FORMAT_DSF, FORMAT_AIF = (
    FileFormat)
FORMAT_NAMES = ("WAV", "W64", "CAF", "DFF", "DSF", "AIF")
FORMAT_EXTENSIONS = ("wav", "w64", "caf", "dff", "dsf", "aif")
