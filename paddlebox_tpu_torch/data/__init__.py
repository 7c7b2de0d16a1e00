from paddlebox_tpu_torch.data.schema import (DataFeedSchema, Slot,  # noqa: F401
                                             SlotType)
from paddlebox_tpu_torch.data.slot_record import (PackedBatch,  # noqa: F401
                                                  SlotRecordBatch,
                                                  SparseLayout)
from paddlebox_tpu_torch.data.parser import parse_multislot_lines  # noqa: F401
from paddlebox_tpu_torch.data.dataset import SlotDataset  # noqa: F401
