// Shared bf16 <-> f32 conversion (round-to-nearest-even) used by both the
// PS wire plane (ps_server.cc typed tables) and the native predictor's
// npy payloads (demo_predictor.cc) — one definition so save/serve parity
// can't silently diverge.
#pragma once

#include <cstdint>
#include <cstring>

inline uint16_t f32_to_bf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  // round-to-nearest-even on the dropped 16 bits
  uint32_t lsb = (bits >> 16) & 1;
  bits += 0x7FFFu + lsb;
  return static_cast<uint16_t>(bits >> 16);
}

inline float bf16_to_f32(uint16_t h) {
  uint32_t bits = static_cast<uint32_t>(h) << 16;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}
