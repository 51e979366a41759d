from tpu_audio.utils.log import Log
from tpu_audio.utils.device import select_device, device_summary
from tpu_audio.utils.profiling import BlockTimer

__all__ = ["Log", "select_device", "device_summary", "BlockTimer"]
