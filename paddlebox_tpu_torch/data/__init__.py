from paddlebox_tpu_torch.data.schema import (DataFeedSchema, Slot,  # noqa: F401
                                             SlotType)
from paddlebox_tpu_torch.data.slot_record import (PackedBatch,  # noqa: F401
                                                  SlotRecordBatch,
                                                  SparseLayout)
from paddlebox_tpu_torch.data.parser import (ParseStats,  # noqa: F401
                                             parse_multislot_lines)
from paddlebox_tpu_torch.data.dataset import SlotDataset  # noqa: F401
from paddlebox_tpu_torch.data.queue_dataset import QueueDataset  # noqa: F401
from paddlebox_tpu_torch.data.archive import (archive_filelist,  # noqa: F401
                                              read_archive, write_archive)
from paddlebox_tpu_torch.data.channel import Channel  # noqa: F401
from paddlebox_tpu_torch.data.data_generator import (  # noqa: F401
    MultiSlotDataGenerator)
