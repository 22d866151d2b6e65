from wsiseg_tpu_torch.slides.reader import (  # noqa: F401
    SlideReader,
    ArraySlide,
    SyntheticSlide,
    VirtualPyramidSlide,
    glob_slides,
    open_slide,
)

# NativeSlide / write_raw_pyramid / write_tiled_pyramid live in
# wsiseg_tpu_torch.slides.native (imported lazily — they build the C++ library
# on first use). Vendor-dialect readers (J2KTiledSlide, NDPISlide,
# PhilipsTiffSlide) live in wsiseg_tpu_torch.slides.{j2k,vendor}; open_slide
# routes to them automatically by content sniff.
