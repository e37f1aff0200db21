"""Model zoo: PyTorch definitions of the architectures ported so far."""
from repro_torch.models.model import BlockSpec, Model, Segment, derive_segments

__all__ = ["Model", "BlockSpec", "Segment", "derive_segments"]
