// Batch request bodies on the host: the base64 audio of a JSON body,
// decoded to f32 samples in one pass, without the interpreter lock.
//
// POST /v2/decode/batch/{model} takes {"audio_buffer": "<base64 of i16LE
// PCM>", ...}. amira_body_decode scans the raw request bytes once: a
// structural scan of the JSON (strings, escapes, nesting depth) finds the
// value of the top-level key "audio_buffer"; the value is checked against
// [A-Za-z0-9+/]*={0,2} with a length that is a multiple of 4, and decoded as
// it is checked into the caller's f32 buffer as i16LE / 32768 (exact in
// f32, so the samples equal numpy's astype(f32) * f32(1/32768) bit for bit).
// Non-zero bits left over in the last quantum are dropped, as binascii
// drops them.
//
// The routine declines (returns a negative code) whenever the body is not
// that plain case: a top level that is not an object, an unterminated
// string, no top-level "audio_buffer" or two of them, an escape inside a
// top-level key, a value that is not a string, any escape or byte outside
// the alphabet in the value, misplaced padding, an empty value, an odd byte
// count, or more audio than the limits allow. The caller then parses the
// body as it would without this routine, so every error answer comes from
// one place. On success the caller parses the rest of the body, with the
// value emptied (bytes [span[0], span[1]) replaced by ""): the two differ
// only inside one string token of base64 characters, so one is valid JSON
// exactly when the other is, and both have the same keys and structure.
//
// Built with g++ into a plain C interface and loaded with ctypes.CDLL
// (server/body.py), which releases the interpreter lock around the call.

#include <cstdint>
#include <cstring>

namespace {

enum Declined : int64_t {
  kNotObject = -1,     // top level is not an object, or a non-UTF-8 start
  kUnterminated = -2,  // a string or the object runs past the end
  kNoKey = -3,         // no top-level "audio_buffer"
  kKeyEscape = -4,     // a top-level key holds an escape
  kDuplicate = -5,     // "audio_buffer" twice at the top level
  kNotString = -6,     // the value is not a string
  kNotBase64 = -7,     // an escape, a byte outside the alphabet, padding
  kEmptyOrOdd = -8,    // no audio, or an odd number of bytes
  kTooLong = -9,       // over the byte or second limit, or the buffer
};

constexpr uint32_t kBad = 1u << 24;  // above any 24-bit quantum

// d[k][c]: the base64 value of byte c placed for the k-th character of a
// quantum (bits 18, 12, 6, 0), or kBad outside the alphabet; OR-ing four
// gives the quantum's 24 bits, or a value >= kBad if any was outside.
struct Tables {
  uint32_t d[4][256];
  constexpr Tables() : d{} {
    for (int c = 0; c < 256; ++c) {
      int v = -1;
      if (c >= 'A' && c <= 'Z') v = c - 'A';
      else if (c >= 'a' && c <= 'z') v = c - 'a' + 26;
      else if (c >= '0' && c <= '9') v = c - '0' + 52;
      else if (c == '+') v = 62;
      else if (c == '/') v = 63;
      for (int k = 0; k < 4; ++k)
        d[k][c] = v < 0 ? kBad : static_cast<uint32_t>(v) << (18 - 6 * k);
    }
  }
};
constexpr Tables kTab;

inline uint32_t quantum(const uint8_t* p) {
  return kTab.d[0][p[0]] | kTab.d[1][p[1]] | kTab.d[2][p[2]] |
         kTab.d[3][p[3]];
}

inline float sample(uint8_t lo, uint8_t hi) {
  return static_cast<float>(static_cast<int16_t>(
             static_cast<uint16_t>(lo | (hi << 8)))) *
         (1.0f / 32768.0f);
}

inline bool is_ws(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

// Index of the quote that closes the string opened just before i, or -1.
// *escaped: the string holds a backslash.
int64_t string_end(const uint8_t* raw, int64_t i, int64_t n, bool* escaped) {
  *escaped = false;
  while (i < n) {
    const void* q = std::memchr(raw + i, '"', static_cast<size_t>(n - i));
    if (q == nullptr) return -1;
    int64_t e = static_cast<const uint8_t*>(q) - raw;
    if (std::memchr(raw + i, '\\', static_cast<size_t>(e - i)) == nullptr)
      return e;
    *escaped = true;
    int64_t k = e;  // the quote is escaped when an odd run of \ precedes it
    while (k > i && raw[k - 1] == '\\') --k;
    if ((e - k) % 2 == 0) return e;
    i = e + 1;
  }
  return -1;
}

constexpr char kKey[] = "audio_buffer";
constexpr int64_t kKeyLen = sizeof(kKey) - 1;

// Decodes the base64 string whose characters start at s into out (at most
// cap samples). Returns the decoded byte count and sets *close to the
// closing quote, or returns a Declined code.
int64_t decode_value(const uint8_t* raw, int64_t s, int64_t n, float* out,
                     int64_t cap, int64_t* close) {
  int64_t p = s, k = 0;
  // 8 characters: two quanta, 6 bytes, 3 samples
  while (p + 8 <= n) {
    uint32_t a = quantum(raw + p), b = quantum(raw + p + 4);
    if ((a | b) >= kBad) break;
    if (k + 3 > cap) return kTooLong;
    out[k] = sample(static_cast<uint8_t>(a >> 16),
                    static_cast<uint8_t>(a >> 8));
    out[k + 1] = sample(static_cast<uint8_t>(a),
                        static_cast<uint8_t>(b >> 16));
    out[k + 2] = sample(static_cast<uint8_t>(b >> 8),
                        static_cast<uint8_t>(b));
    k += 3;
    p += 8;
  }
  // the tail: fewer than 8 alphabet characters, up to 2 '=', the quote
  uint64_t bits = 0;  // up to 7 characters, 42 bits
  int m = 0;
  while (p < n && kTab.d[3][raw[p]] != kBad) {
    bits = (bits << 6) | kTab.d[3][raw[p]];
    ++m;
    ++p;
  }
  int pads = 0;
  while (p < n && raw[p] == '=' && pads < 2) {
    ++pads;
    ++p;
  }
  if (p >= n || raw[p] != '"' || (m + pads) % 4 != 0) return kNotBase64;
  // m % 4 == 0 with no pads, 3 with one, 2 with two
  uint8_t tail[6];
  int t = 0;
  for (int q = 0; q < m / 4; ++q) {
    uint64_t v = bits >> (6 * (m - 4 * (q + 1)));
    tail[t++] = static_cast<uint8_t>(v >> 16);
    tail[t++] = static_cast<uint8_t>(v >> 8);
    tail[t++] = static_cast<uint8_t>(v);
  }
  uint64_t rest = bits & ((uint64_t{1} << (6 * (m % 4))) - 1);
  if (m % 4 == 3) {  // 18 bits: 2 bytes and 2 dropped bits
    tail[t++] = static_cast<uint8_t>(rest >> 10);
    tail[t++] = static_cast<uint8_t>(rest >> 2);
  } else if (m % 4 == 2) {  // 12 bits: 1 byte and 4 dropped bits
    tail[t++] = static_cast<uint8_t>(rest >> 4);
  }
  if (t % 2 != 0) return kEmptyOrOdd;
  if (k + t / 2 > cap) return kTooLong;
  for (int q = 0; q < t; q += 2) out[k++] = sample(tail[q], tail[q + 1]);
  *close = p;
  return 2 * k;
}

}  // namespace

extern "C" {

// raw[0, n): the request body. out: room for cap f32 samples. The audio is
// accepted if its byte count b is even, 0 < b <= max_bytes and
// b / bytes_per_sec <= max_secs (the server's own checks, in its
// arithmetic). Returns the sample count and sets span[0], span[1] to the
// value's quotes ([span[0], span[1]) is the string token), or a negative
// code when it declines; out may then hold partial samples.
int64_t amira_body_decode(const uint8_t* raw, int64_t n, float* out,
                          int64_t cap, int64_t max_bytes, double max_secs,
                          double bytes_per_sec, int64_t* span) {
  // json.loads reads a body as UTF-8 unless it starts with a byte-order
  // mark or has a NUL among its first bytes (UTF-16 and UTF-32); a plain
  // body starts with whitespace or '{' and has no NUL there
  if (n < 4 || std::memchr(raw, 0, 4) != nullptr) return kNotObject;
  int64_t i = 0;
  while (i < n && is_ws(raw[i])) ++i;
  if (i >= n || raw[i] != '{') return kNotObject;
  ++i;
  int64_t depth = 1, got = -1;
  bool key_next = true;  // the next string at depth 1 is a key
  while (i < n && depth > 0) {
    uint8_t c = raw[i];
    if (c == '"') {
      bool escaped;
      int64_t e = string_end(raw, i + 1, n, &escaped);
      if (e < 0) return kUnterminated;
      if (depth == 1 && key_next) {
        key_next = false;
        if (escaped) return kKeyEscape;
        bool ours = e - (i + 1) == kKeyLen &&
                    std::memcmp(raw + i + 1, kKey, kKeyLen) == 0;
        i = e + 1;
        if (!ours) continue;
        if (got >= 0) return kDuplicate;
        while (i < n && is_ws(raw[i])) ++i;
        if (i >= n || raw[i] != ':') return kNotString;
        ++i;
        while (i < n && is_ws(raw[i])) ++i;
        if (i >= n || raw[i] != '"') return kNotString;
        int64_t close = -1;
        int64_t bytes = decode_value(raw, i + 1, n, out, cap, &close);
        if (bytes < 0) return bytes;
        if (bytes == 0) return kEmptyOrOdd;
        if (bytes > max_bytes ||
            static_cast<double>(bytes) / bytes_per_sec > max_secs)
          return kTooLong;
        span[0] = i;
        span[1] = close + 1;
        got = bytes / 2;
        i = close + 1;
        continue;
      }
      i = e + 1;
      continue;
    }
    if (c == '{' || c == '[') {
      ++depth;
    } else if (c == '}' || c == ']') {
      --depth;
    } else if (c == ',' && depth == 1) {
      key_next = true;
    }
    ++i;
  }
  if (depth > 0) return kUnterminated;
  return got >= 0 ? got : kNoKey;
}

}  // extern "C"
