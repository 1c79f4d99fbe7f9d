"""Native (C++) host preprocessing, built at first use, with a numpy / PIL
path where no compiler is found."""
from .wrapper import crop_u8, dilate7, native_available, resize_bicubic_to_pm1

__all__ = ["crop_u8", "dilate7", "native_available", "resize_bicubic_to_pm1"]
