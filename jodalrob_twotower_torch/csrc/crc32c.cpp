// CRC32C (Castagnoli), slice-by-8 software implementation, for the TFRecord
// framing of io/tfrecord.py (the copy of jodalrob_twotower_tpu/native/
// gather.cpp's crc32c the port keeps). Host code: built with g++ at first use
// (ops/_build.build_host) and loaded through ctypes by io/crc32c.py.

#include <cstdint>

namespace {

uint32_t kCrcTable[8][256];
const bool kCrcInit = []() {
  const uint32_t poly = 0x82F63B78u;  // reflected CRC-32C
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    kCrcTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      kCrcTable[t][i] = (kCrcTable[t - 1][i] >> 8) ^ kCrcTable[0][kCrcTable[t - 1][i] & 0xFF];
  return true;
}();

}  // namespace

extern "C" {

// crc32c of n bytes at data, continuing from crc (0 for a fresh checksum).
uint32_t crc32c(const uint8_t* data, uint64_t n, uint32_t crc) {
  crc = ~crc;
  while (n >= 8) {
    crc ^= (uint32_t)data[0] | ((uint32_t)data[1] << 8) |
           ((uint32_t)data[2] << 16) | ((uint32_t)data[3] << 24);
    uint32_t hi = (uint32_t)data[4] | ((uint32_t)data[5] << 8) |
                  ((uint32_t)data[6] << 16) | ((uint32_t)data[7] << 24);
    crc = kCrcTable[7][crc & 0xFF] ^ kCrcTable[6][(crc >> 8) & 0xFF] ^
          kCrcTable[5][(crc >> 16) & 0xFF] ^ kCrcTable[4][crc >> 24] ^
          kCrcTable[3][hi & 0xFF] ^ kCrcTable[2][(hi >> 8) & 0xFF] ^
          kCrcTable[1][(hi >> 16) & 0xFF] ^ kCrcTable[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kCrcTable[0][(crc ^ *data++) & 0xFF];
  return ~crc;
}

}  // extern "C"
