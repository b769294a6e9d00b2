from .pipeline import IspConfig, isp_process, load_isp_config  # noqa: F401
from .raw import (  # noqa: F401
    convert_8bit_frame,
    convert_12bit_frame,
    convert_16bit_frame,
    pack_12bit_frame,
)
from .footage import BinaryFootageReader, write_footage_file  # noqa: F401
