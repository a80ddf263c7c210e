// wire-coherence fixture (C++ side).          lint: wire-coherence/native-fallback
// kFlagNormal drifted off the Python byte, and the non-NORMAL fallback
// route (everything the fast path does not own returns 0 to land in the
// Python inbox/misc drain) is gone: a frame with an unknown flag byte
// is consumed silently.  Never compiled — linted statically.
#include <cstdint>

static constexpr uint8_t kFlagNormal = 0x01;  // lint: wire-coherence/constant-mismatch
static constexpr uint8_t kFlagBatch = 0xB7;

// the batch splitter survives (keeps the kFlagBatch pin green)
static int split(uint64_t tagw) {
  if ((tagw & 0xFF) == kFlagBatch) return 1;
  return 2;
}
