// Clean-control fixture (C++ side): constants in sync with
// _clean_control.py, fallback route and batch splitter intact.
#include <cstdint>

static constexpr uint8_t kFlagNormal = 0x00;
static constexpr uint8_t kFlagBatch = 0xB7;

static int route(uint64_t tagw) {
  if ((tagw & 0xFF) != kFlagNormal) return 0;  // fallback to Python inbox
  return 1;
}

static int split(uint64_t tagw) {
  if ((tagw & 0xFF) == kFlagBatch) return 1;
  return 2;
}
