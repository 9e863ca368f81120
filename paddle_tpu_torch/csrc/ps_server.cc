// Parameter-server runtime: TCP KV store with server-side optimizers.
//
// TPU-native stand-in for the reference's RPC parameter-server plane
// (operators/distributed/: grpc_server.cc async service, request_handler_impl.cc
// server-side optimize blocks, parameter_send/recv.cc, brpc/*), collapsed to
// the essential architecture: a threaded socket server owning named dense
// and sparse (row-sharded, SelectedRows-analog) float32 tables, applying
// SGD/momentum/adagrad/adam updates in native code, with sync-mode
// accumulate-until-all-trainers semantics (ref listen_and_serv_op.cc
// RunSyncLoop barriers) and async apply-on-push (RunAsyncLoop).
//
// Wire protocol (all little-endian):
//   request : u8 op | u16 name_len | name | u32 rows | u64 payload_len |
//             [rows * u32 row ids] | [payload bytes] | u32 crc32
//   response: u64 payload_len | payload | u32 crc32
// The CRC32 (IEEE) covers rows+payload (request) / payload (response) and
// is verified before any table mutation; frames are assembled with
// writev so header+payload+crc reach the kernel without a concatenation
// copy.  The error response is the bare all-ones length sentinel (no
// crc).
// ops: 0 PUT  1 GET  2 PUSH_DENSE  3 BARRIER  4 PUSH_SPARSE  5 GET_ROWS
//      6 STOP 7 GET_NOBARRIER
// typed ops (8 PUT_TYPED 9 GET_TYPED 10 PUSH_TYPED) carry one extra u8
// dtype right after the op byte and move raw element bytes (ref
// send_recv.proto.in:47 VariableMessage.dtype): bf16 tables ride the
// wire at half the bytes with an f32 master copy server-side; int64
// tables (CTR frequency counters) are exact end to end.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "bf16.h"

namespace {

enum Op : uint8_t {
  kPut = 0,
  kGet = 1,
  kPushDense = 2,
  kBarrier = 3,
  kPushSparse = 4,
  kGetRows = 5,
  kStop = 6,
  kGetNoBarrier = 7,
  kPutTyped = 8,
  kGetTyped = 9,
  kPushTyped = 10,
};

enum Optim : int32_t { kSGD = 0, kMomentum = 1, kAdagrad = 2, kAdam = 3 };

enum Dtype : uint8_t { kF32 = 0, kBF16 = 1, kI64 = 2 };

inline size_t dtype_size(uint8_t d) { return d == kI64 ? 8 : d == kBF16 ? 2 : 4; }

struct Param {
  std::vector<float> value;
  std::vector<float> grad_acc;    // sync-mode accumulator
  std::vector<float> m0, m1;      // optimizer slots
  std::vector<int64_t> vi64;      // int64 table storage (dtype==kI64)
  uint8_t dtype = kF32;           // wire dtype (bf16 keeps f32 master)
  int64_t rows = 0;               // >0: sparse table [rows, width]
  int64_t width = 0;
  int optim = kSGD;
  float lr = 0.01f, mom = 0.9f, beta1 = 0.9f, beta2 = 0.999f, eps = 1e-8f;
  int push_count = 0;             // pushes since last apply
  int64_t version = 0;
  int64_t adam_t = 0;
};

struct Server {
  int port = 0;
  int num_trainers = 1;
  bool sync_mode = true;
  int listen_fd = -1;
  std::atomic<bool> running{false};
  std::thread accept_thread;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, Param> table;
  std::vector<int> conn_fds;      // live connections, for shutdown
  int barrier_count = 0;
  int64_t barrier_gen = 0;
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// CRC32 (IEEE, reflected 0xEDB88320) — end-to-end frame integrity over
// the payload bytes, beyond TCP's weak 16-bit checksum (the reference's
// bRPC transport verifies attachments the same way).  Running form so
// multi-buffer frames fold without concatenation.
uint32_t crc32_update(uint32_t crc, const void* buf, size_t n) {
  // slicing-by-8: ~8 bytes per table round, keeping the check cheap on
  // multi-GB pushes (a byte-at-a-time loop would serialize seconds of
  // CPU on the connection thread for payloads near the 2^34 cap)
  static uint32_t t[8][256];
  static std::once_flag once;
  std::call_once(once, [] {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (int j = 1; j < 8; j++)
      for (uint32_t i = 0; i < 256; i++)
        t[j][i] = (t[j - 1][i] >> 8) ^ t[0][t[j - 1][i] & 0xFF];
  });
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  crc = ~crc;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^
          t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
          t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
          t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// Vectored full write: the whole frame (header + payload + crc) reaches
// the kernel in one writev — no user-space concatenation copy, and no
// header/payload segment split on the wire (≈ grpc_serde's zero-copy
// bytebuffer assembly).
bool writev_full(int fd, struct iovec* iov, int iovcnt) {
  while (iovcnt > 0) {
    ssize_t r = ::writev(fd, iov, iovcnt);
    if (r <= 0) return false;
    size_t done = static_cast<size_t>(r);
    while (iovcnt > 0 && done >= iov[0].iov_len) {
      done -= iov[0].iov_len;
      ++iov;
      --iovcnt;
    }
    if (iovcnt > 0 && done > 0) {
      iov[0].iov_base = static_cast<char*>(iov[0].iov_base) + done;
      iov[0].iov_len -= done;
    }
  }
  return true;
}

bool send_payload(int fd, const float* data, size_t n_floats) {
  uint64_t len = n_floats * sizeof(float);
  uint32_t crc = crc32_update(0, data, len);
  struct iovec iov[3] = {{&len, sizeof(len)},
                         {const_cast<float*>(data), static_cast<size_t>(len)},
                         {&crc, sizeof(crc)}};
  if (n_floats == 0) {
    iov[1] = iov[2];
    return writev_full(fd, iov, 2);
  }
  return writev_full(fd, iov, 3);
}

bool send_bytes(int fd, const void* data, size_t n_bytes) {
  uint64_t len = n_bytes;
  uint32_t crc = crc32_update(0, data, n_bytes);
  struct iovec iov[3] = {{&len, sizeof(len)},
                         {const_cast<void*>(data), n_bytes},
                         {&crc, sizeof(crc)}};
  if (n_bytes == 0) {
    iov[1] = iov[2];
    return writev_full(fd, iov, 2);
  }
  return writev_full(fd, iov, 3);
}

// Error response: payload_len sentinel of all-ones (a real payload is
// bounded at 2^34 by the request validator, so this is unambiguous).
bool send_error(int fd) {
  uint64_t len = ~0ull;
  return write_full(fd, &len, sizeof(len));
}

// CRC-reject sentinel (~1): the request was verifiably NOT applied, so
// the client may resend it even when the op is non-idempotent — unlike
// the generic error, which means the request WAS served.
bool send_crc_reject(int fd) {
  uint64_t len = ~1ull;
  return write_full(fd, &len, sizeof(len));
}

// Apply one optimizer step to `n` contiguous floats at offset `off`.
// Dense: off=0, n=value.size(); sparse: one row at a time.
void apply_update(Param& p, const float* grad, size_t off, size_t n) {
  float* v = p.value.data() + off;
  switch (p.optim) {
    case kSGD:
      for (size_t i = 0; i < n; i++) v[i] -= p.lr * grad[i];
      break;
    case kMomentum: {
      if (p.m0.size() != p.value.size()) p.m0.assign(p.value.size(), 0.f);
      float* m = p.m0.data() + off;
      for (size_t i = 0; i < n; i++) {
        m[i] = p.mom * m[i] + grad[i];
        v[i] -= p.lr * m[i];
      }
      break;
    }
    case kAdagrad: {
      if (p.m0.size() != p.value.size()) p.m0.assign(p.value.size(), 0.f);
      float* m = p.m0.data() + off;
      for (size_t i = 0; i < n; i++) {
        m[i] += grad[i] * grad[i];
        v[i] -= p.lr * grad[i] / (std::sqrt(m[i]) + p.eps);
      }
      break;
    }
    case kAdam: {
      if (p.m0.size() != p.value.size()) {
        p.m0.assign(p.value.size(), 0.f);
        p.m1.assign(p.value.size(), 0.f);
      }
      // adam_t is bumped by the caller once per logical step
      float* m = p.m0.data() + off;
      float* u = p.m1.data() + off;
      double bc1 = 1.0 - std::pow(p.beta1, static_cast<double>(p.adam_t));
      double bc2 = 1.0 - std::pow(p.beta2, static_cast<double>(p.adam_t));
      for (size_t i = 0; i < n; i++) {
        m[i] = p.beta1 * m[i] + (1 - p.beta1) * grad[i];
        u[i] = p.beta2 * u[i] + (1 - p.beta2) * grad[i] * grad[i];
        float mh = static_cast<float>(m[i] / bc1);
        float uh = static_cast<float>(u[i] / bc2);
        v[i] -= p.lr * mh / (std::sqrt(uh) + p.eps);
      }
      break;
    }
  }
  p.version++;
}

void handle_conn(Server* s, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->conn_fds.push_back(fd);
  }
  // sync-mode round tracking: param -> version seen at this connection's
  // last push.  A GET waits until the version advances PAST that push's
  // round — not until push_count==0, which deadlocks when a fast trainer
  // pushes round k+1 before a slow trainer's round-k GET (the reference
  // orders rounds with explicit send/get barriers; this per-connection
  // version watermark is the equivalent).
  std::map<std::string, int64_t> pending;
  while (s->running.load()) {
    uint8_t op;
    if (!read_full(fd, &op, 1)) break;
    uint8_t dtype = kF32;
    bool typed = op == kPutTyped || op == kGetTyped || op == kPushTyped;
    if (typed && !read_full(fd, &dtype, 1)) break;
    uint16_t name_len;
    if (!read_full(fd, &name_len, sizeof(name_len))) break;
    std::string name(name_len, '\0');
    if (name_len && !read_full(fd, &name[0], name_len)) break;
    uint32_t n_rows;
    if (!read_full(fd, &n_rows, sizeof(n_rows))) break;
    uint64_t payload_len;
    if (!read_full(fd, &payload_len, sizeof(payload_len))) break;
    if (payload_len % dtype_size(dtype) != 0 ||
        payload_len > (1ull << 34)) break;  // malformed request
    std::vector<uint32_t> rows(n_rows);
    if (n_rows && !read_full(fd, rows.data(),
                         static_cast<size_t>(n_rows) * 4)) break;
    std::vector<uint8_t> raw;           // typed ops: raw element bytes
    std::vector<float> payload;
    if (typed) {
      raw.resize(payload_len);
      if (payload_len && !read_full(fd, raw.data(), payload_len)) break;
    } else {
      payload.resize(payload_len / sizeof(float));
      if (payload_len && !read_full(fd, payload.data(), payload_len)) break;
    }
    // frame integrity: CRC32 over rows + payload, verified BEFORE any
    // table mutation — a corrupted push is rejected, never applied (so
    // the client may safely resend it)
    uint32_t want_crc;
    if (!read_full(fd, &want_crc, sizeof(want_crc))) break;
    // the CRC covers the WHOLE frame — header included, so a bit-flip in
    // the name can't mutate (or ghost-create) the wrong table
    uint32_t got_crc = crc32_update(0, &op, 1);
    if (typed) got_crc = crc32_update(got_crc, &dtype, 1);
    got_crc = crc32_update(got_crc, &name_len, sizeof(name_len));
    got_crc = crc32_update(got_crc, name.data(), name.size());
    got_crc = crc32_update(got_crc, &n_rows, sizeof(n_rows));
    got_crc = crc32_update(got_crc, &payload_len, sizeof(payload_len));
    got_crc = crc32_update(got_crc, rows.data(),
                           static_cast<size_t>(n_rows) * 4);
    got_crc = typed
                  ? crc32_update(got_crc, raw.data(), raw.size())
                  : crc32_update(got_crc, payload.data(),
                                 payload.size() * sizeof(float));
    if (got_crc != want_crc) {
      send_crc_reject(fd);
      break;                            // desynced/corrupt stream: drop
    }

    if (op == kStop) {
      std::lock_guard<std::mutex> lk(s->mu);
      s->running.store(false);
      s->cv.notify_all();
      send_payload(fd, nullptr, 0);
      // unblock accept() and every worker blocked on a client read
      for (int cfd : s->conn_fds)
        if (cfd != fd) ::shutdown(cfd, SHUT_RDWR);
      ::shutdown(s->listen_fd, SHUT_RDWR);
      break;
    }

    std::unique_lock<std::mutex> lk(s->mu);
    Param* pp = nullptr;
    if (op == kPut || op == kPutTyped) {
      pp = &s->table[name];  // PUT registers the table
    } else if (op != kBarrier) {
      // never default-insert on reads/pushes: a misrouted or typo'd name
      // must fail loudly, not silently train a ghost default-SGD entry
      auto it = s->table.find(name);
      if (it == s->table.end()) {
        send_error(fd);
        continue;
      }
      pp = &it->second;
    }
    static Param dummy;  // kBarrier never touches the table
    Param& p = pp ? *pp : dummy;
    switch (op) {
      case kPut: {
        p.value = payload;
        if (p.width == 0) p.width = static_cast<int64_t>(payload.size());
        send_payload(fd, nullptr, 0);
        break;
      }
      case kGet: {
        // sync mode: wait until the round this connection pushed into has
        // been applied (ref RunSyncLoop's Send-barrier before Get)
        auto it = pending.find(name);
        if (s->sync_mode && it != pending.end()) {
          int64_t watermark = it->second;
          s->cv.wait(lk, [&] {
            return !s->running.load() || p.version > watermark;
          });
          pending.erase(name);
        }
        send_payload(fd, p.value.data(), p.value.size());
        break;
      }
      case kGetNoBarrier: {
        send_payload(fd, p.value.data(), p.value.size());
        break;
      }
      case kPushDense: {
        if (p.value.empty()) p.value.assign(payload.size(), 0.f);
        if (payload.size() != p.value.size()) {
          // push_dense always carries the full parameter: oversize would
          // write past the table, undersize would reset grad_acc mid-round
          send_error(fd);
          break;
        }
        pending[name] = p.version;      // this round's watermark
        if (s->sync_mode && s->num_trainers > 1) {
          if (p.grad_acc.size() != payload.size())
            p.grad_acc.assign(payload.size(), 0.f);
          for (size_t i = 0; i < payload.size(); i++)
            p.grad_acc[i] += payload[i];
          p.push_count++;
          if (p.push_count >= s->num_trainers) {
            for (size_t i = 0; i < p.grad_acc.size(); i++)
              p.grad_acc[i] /= static_cast<float>(s->num_trainers);
            if (p.optim == kAdam) p.adam_t++;
            apply_update(p, p.grad_acc.data(), 0, p.grad_acc.size());
            p.grad_acc.assign(p.grad_acc.size(), 0.f);
            p.push_count = 0;
            s->cv.notify_all();
          }
        } else {
          if (p.optim == kAdam) p.adam_t++;
          apply_update(p, payload.data(), 0, payload.size());
        }
        send_payload(fd, nullptr, 0);
        break;
      }
      case kPushSparse: {
        // payload is [n_rows, width]; apply per-row (async semantics —
        // ref async_sparse_param_update_recorder.h / SelectedRows merge)
        int64_t w = p.width;
        if (w == 0 && n_rows) {
          w = static_cast<int64_t>(payload.size() / n_rows);
          p.width = w;
        }
        if (p.optim == kAdam) p.adam_t++;
        for (uint32_t r = 0; r < n_rows; r++) {
          size_t off = static_cast<size_t>(rows[r]) * w;
          if (off + w <= p.value.size())
            apply_update(p, payload.data() + r * w, off, w);
        }
        send_payload(fd, nullptr, 0);
        break;
      }
      case kGetRows: {
        int64_t w = p.width;
        std::vector<float> out(static_cast<size_t>(n_rows) * w);
        for (uint32_t r = 0; r < n_rows; r++) {
          size_t off = static_cast<size_t>(rows[r]) * w;
          if (off + w <= p.value.size())
            std::memcpy(out.data() + r * w, p.value.data() + off,
                        w * sizeof(float));
        }
        send_payload(fd, out.data(), out.size());
        break;
      }
      case kPutTyped: {
        p.dtype = dtype;
        if (dtype == kI64) {
          p.vi64.assign(
              reinterpret_cast<const int64_t*>(raw.data()),
              reinterpret_cast<const int64_t*>(raw.data() + raw.size()));
          if (p.width == 0) p.width = static_cast<int64_t>(p.vi64.size());
        } else if (dtype == kBF16) {
          const uint16_t* src = reinterpret_cast<const uint16_t*>(raw.data());
          p.value.resize(raw.size() / 2);
          for (size_t i = 0; i < p.value.size(); i++)
            p.value[i] = bf16_to_f32(src[i]);  // f32 master server-side
          if (p.width == 0) p.width = static_cast<int64_t>(p.value.size());
        } else {
          p.value.assign(
              reinterpret_cast<const float*>(raw.data()),
              reinterpret_cast<const float*>(raw.data() + raw.size()));
          if (p.width == 0) p.width = static_cast<int64_t>(p.value.size());
        }
        send_payload(fd, nullptr, 0);
        break;
      }
      case kGetTyped: {
        if (dtype != p.dtype) {
          send_error(fd);
          break;
        }
        if (dtype == kI64) {
          send_bytes(fd, p.vi64.data(), p.vi64.size() * 8);
        } else if (dtype == kBF16) {
          std::vector<uint16_t> out(p.value.size());
          for (size_t i = 0; i < out.size(); i++)
            out[i] = f32_to_bf16(p.value[i]);
          send_bytes(fd, out.data(), out.size() * 2);
        } else {
          send_payload(fd, p.value.data(), p.value.size());
        }
        break;
      }
      case kPushTyped: {
        if (dtype != p.dtype) {
          send_error(fd);
          break;
        }
        if (dtype == kI64) {
          // int64 tables are accumulators (CTR show/click counters):
          // dense add, or per-row add when rows are given
          const int64_t* g = reinterpret_cast<const int64_t*>(raw.data());
          size_t n = raw.size() / 8;
          if (n_rows) {
            // row width comes from the push payload itself (a dense PUT
            // can't know the row structure)
            int64_t w = static_cast<int64_t>(n / n_rows);
            for (uint32_t r = 0; r < n_rows; r++) {
              size_t off = static_cast<size_t>(rows[r]) * w;
              for (int64_t i = 0; i < w && off + i < p.vi64.size(); i++)
                p.vi64[off + i] += g[r * w + i];
            }
          } else {
            for (size_t i = 0; i < n && i < p.vi64.size(); i++)
              p.vi64[i] += g[i];
          }
        } else {
          // bf16 grads: widen to f32 and run the table's optimizer
          // against the f32 master (dense or per-row)
          std::vector<float> g;
          if (dtype == kBF16) {
            const uint16_t* src =
                reinterpret_cast<const uint16_t*>(raw.data());
            g.resize(raw.size() / 2);
            for (size_t i = 0; i < g.size(); i++) g[i] = bf16_to_f32(src[i]);
          } else {
            g.assign(reinterpret_cast<const float*>(raw.data()),
                     reinterpret_cast<const float*>(raw.data() + raw.size()));
          }
          if (!n_rows && g.size() != p.value.size()) {
            // DENSE pushes always carry the full parameter: oversize
            // would write past the table (and its m0/m1 slots),
            // undersize would train only a prefix — reject both;
            // per-row pushes are bounds-checked row by row below
            send_error(fd);
            break;
          }
          if (p.optim == kAdam) p.adam_t++;
          if (n_rows) {
            int64_t w = static_cast<int64_t>(g.size() / n_rows);
            for (uint32_t r = 0; r < n_rows; r++) {
              size_t off = static_cast<size_t>(rows[r]) * w;
              if (off + w <= p.value.size())
                apply_update(p, g.data() + r * w, off, w);
            }
          } else {
            apply_update(p, g.data(), 0, g.size());
          }
        }
        send_payload(fd, nullptr, 0);
        break;
      }
      case kBarrier: {
        int64_t gen = s->barrier_gen;
        if (++s->barrier_count >= s->num_trainers) {
          s->barrier_count = 0;
          s->barrier_gen++;
          s->cv.notify_all();
        } else {
          s->cv.wait(lk, [&] {
            return !s->running.load() || s->barrier_gen != gen;
          });
        }
        send_payload(fd, nullptr, 0);
        break;
      }
      default:
        send_payload(fd, nullptr, 0);
    }
  }
  {
    std::lock_guard<std::mutex> lk(s->mu);
    for (auto it = s->conn_fds.begin(); it != s->conn_fds.end(); ++it)
      if (*it == fd) { s->conn_fds.erase(it); break; }
  }
  ::close(fd);
}

void accept_loop(Server* s) {
  while (s->running.load()) {
    int fd = ::accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (!s->running.load()) break;
      continue;
    }
    s->workers.emplace_back(handle_conn, s, fd);
  }
}

}  // namespace

extern "C" {

void* ps_server_create(int port, int num_trainers, int sync_mode) {
  Server* s = new Server();
  s->port = port;
  s->num_trainers = num_trainers;
  s->sync_mode = sync_mode != 0;
  return s;
}

// Register a table before start.  rows=0 → dense of size `size`;
// rows>0 → sparse table [rows, size/rows] (size = rows*width).
int ps_server_add_param(void* h, const char* name, int64_t size,
                        const float* init, int optim, float lr, float hp1,
                        float hp2, int64_t rows) {
  Server* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  Param& p = s->table[name];
  p.value.assign(init, init + size);
  p.optim = optim;
  p.lr = lr;
  if (optim == kMomentum) p.mom = hp1;
  if (optim == kAdam) { p.beta1 = hp1; p.beta2 = hp2; }
  p.rows = rows;
  p.width = rows > 0 ? size / rows : size;
  return 0;
}

int ps_server_start(void* h) {
  Server* s = static_cast<Server*>(h);
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) return -1;
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  // ANY, not LOOPBACK: pserver endpoints may be reached from other hosts
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(s->port));
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0)
    return -2;
  if (::listen(s->listen_fd, 64) != 0) return -3;
  if (s->port == 0) {
    socklen_t len = sizeof(addr);
    getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    s->port = ntohs(addr.sin_port);
  }
  s->running.store(true);
  s->accept_thread = std::thread(accept_loop, s);
  return s->port;
}

void ps_server_wait(void* h) {
  Server* s = static_cast<Server*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv.wait(lk, [&] { return !s->running.load(); });
}

void ps_server_stop(void* h) {
  Server* s = static_cast<Server*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->running.store(false);
    s->cv.notify_all();
    // unblock workers stuck reading from clients that never disconnect
    for (int fd : s->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  if (s->listen_fd >= 0) ::shutdown(s->listen_fd, SHUT_RDWR);
}

int ps_server_get(void* h, const char* name, float* out, int64_t size) {
  Server* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->table.find(name);
  if (it == s->table.end()) return -1;
  int64_t n = std::min<int64_t>(size,
                                static_cast<int64_t>(it->second.value.size()));
  std::memcpy(out, it->second.value.data(), n * sizeof(float));
  return static_cast<int>(n);
}

void ps_server_destroy(void* h) {
  Server* s = static_cast<Server*>(h);
  ps_server_stop(s);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  for (auto& t : s->workers)
    if (t.joinable()) t.join();
  if (s->listen_fd >= 0) ::close(s->listen_fd);
  delete s;
}

// ---------------------------------------------------------------------------
// client (ref operators/distributed/grpc/grpc_client.cc AsyncSendVar /
// AsyncGetVar — synchronous here; the Python Communicator supplies the
// async batching on top)
// ---------------------------------------------------------------------------

struct Client {
  int fd = -1;
  std::mutex mu;
  std::string host;
  int port = 0;
  long deadline_ms = 180000;
};

namespace {
long rpc_deadline_ms() {
  // ref FLAGS_rpc_deadline, grpc_client.h:36 — default 180s: a wedged
  // server turns into a clean client error, not a hang
  long deadline_ms = 180000;
  if (const char* env = getenv("FLAGS_rpc_deadline")) {
    long v = strtol(env, nullptr, 10);
    if (v > 0) deadline_ms = v;
  }
  return deadline_ms;
}

int rpc_retry_times() {
  // ref FLAGS_rpc_retry_times (grpc_client retry loop): bounded retries
  // with exponential backoff before surfacing the error
  long v = 3;
  if (const char* env = getenv("FLAGS_rpc_retry_times")) {
    long e = strtol(env, nullptr, 10);
    if (e >= 0) v = e;
  }
  return static_cast<int>(v);
}

// one TCP connect attempt loop (server may not be up yet — ref
// WaitServerReady in grpc_client); returns fd or -1
int connect_fd(const std::string& host, int port, long deadline_ms,
               int attempts) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    // not dotted-quad: resolve the hostname (PaddleCloud-style endpoints
    // are usually names, not IPs)
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (getaddrinfo(host.c_str(), nullptr, &hints, &res) != 0 ||
        res == nullptr)
      return -1;
    addr.sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
    freeaddrinfo(res);
  }
  timeval tv{};
  tv.tv_sec = deadline_ms / 1000;
  tv.tv_usec = (deadline_ms % 1000) * 1000;
  for (int attempt = 0; attempt < attempts; attempt++) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr),
                  sizeof(addr)) == 0) {
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
      return fd;
    }
    ::close(fd);
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
  return -1;
}
}  // namespace

void* ps_client_connect(const char* host, int port) {
  Client* c = new Client();
  c->host = host;
  c->port = port;
  c->deadline_ms = rpc_deadline_ms();
  c->fd = connect_fd(c->host, c->port, c->deadline_ms, 200);
  if (c->fd < 0) {
    delete c;
    return nullptr;
  }
  return c;
}

namespace {
// single attempt.  `sent` reports whether the full request reached the
// kernel send path — the retry policy depends on it (a request that was
// never delivered is safe to resend for ANY op; one that may have been
// applied is only safe for idempotent ops).
int64_t request_once(Client* c, uint8_t op, int dtype, const char* name,
                     const uint32_t* rows, uint32_t n_rows,
                     const void* payload, uint64_t payload_len,
                     void* out, uint64_t out_cap_bytes, bool* sent) {
  *sent = false;
  uint16_t name_len = static_cast<uint16_t>(std::strlen(name));
  uint8_t d = static_cast<uint8_t>(dtype);
  uint32_t crc = crc32_update(0, &op, 1);
  if (dtype >= 0) crc = crc32_update(crc, &d, 1);
  crc = crc32_update(crc, &name_len, sizeof(name_len));
  crc = crc32_update(crc, name, name_len);
  crc = crc32_update(crc, &n_rows, sizeof(n_rows));
  crc = crc32_update(crc, &payload_len, sizeof(payload_len));
  crc = crc32_update(crc, rows, static_cast<size_t>(n_rows) * 4);
  crc = crc32_update(crc, payload, payload_len);
  // whole request in one writev: header fields + rows + payload + crc
  struct iovec iov[8];
  int nv = 0;
  iov[nv++] = {&op, 1};
  if (dtype >= 0) iov[nv++] = {&d, 1};
  iov[nv++] = {&name_len, sizeof(name_len)};
  if (name_len)
    iov[nv++] = {const_cast<char*>(name), static_cast<size_t>(name_len)};
  iov[nv++] = {&n_rows, sizeof(n_rows)};
  iov[nv++] = {&payload_len, sizeof(payload_len)};
  if (n_rows)
    iov[nv++] = {const_cast<uint32_t*>(rows),
                 static_cast<size_t>(n_rows) * 4};
  if (payload_len)
    iov[nv++] = {const_cast<void*>(payload),
                 static_cast<size_t>(payload_len)};
  // crc rides a second writev only when the iovec budget is spent
  bool crc_inline = nv < 8;
  if (crc_inline) iov[nv++] = {&crc, sizeof(crc)};
  if (!writev_full(c->fd, iov, nv)) return -1;
  if (!crc_inline && !write_full(c->fd, &crc, sizeof(crc))) return -1;
  *sent = true;
  uint64_t resp_len;
  if (!read_full(c->fd, &resp_len, sizeof(resp_len))) return -1;
  if (resp_len == ~0ull) return -2;  // server error: unknown table/dtype
  if (resp_len == ~1ull) return -3;  // CRC reject: NOT applied — resend
  // read straight into the caller's buffer (no temp copy on the hot
  // recv path); drain any excess to keep the stream in sync
  uint64_t remaining = resp_len;
  uint32_t rcrc = 0;
  if (out && out_cap_bytes > 0 && remaining > 0) {
    uint64_t take = std::min<uint64_t>(remaining, out_cap_bytes);
    if (!read_full(c->fd, out, take)) return -1;
    rcrc = crc32_update(rcrc, out, take);
    remaining -= take;
  }
  char scratch[4096];
  while (remaining > 0) {
    size_t chunk = static_cast<size_t>(
        std::min<uint64_t>(remaining, sizeof(scratch)));
    if (!read_full(c->fd, scratch, chunk)) return -1;
    rcrc = crc32_update(rcrc, scratch, chunk);
    remaining -= chunk;
  }
  uint32_t want = 0;
  if (!read_full(c->fd, &want, sizeof(want))) return -1;
  if (want != rcrc) return -1;  // corrupted response: retry path decides
  return static_cast<int64_t>(resp_len);
}

bool op_idempotent(uint8_t op) {
  // PUT overwrites, GETs read — safe to replay after an ambiguous
  // failure.  PUSH accumulates and BARRIER counts arrivals: replaying
  // one that may have been applied would double-count.
  switch (op) {
    case kPut:
    case kPutTyped:
    case kGet:
    case kGetNoBarrier:
    case kGetTyped:
    case kGetRows:
      return true;
    default:
      return false;
  }
}

// retries with reconnect + bounded exponential backoff (100ms·2^k); the
// byte count of the response is returned, -1 on exhausted retries, -2
// on a server-reported error (no retry — the request WAS served).
int64_t request_bytes(Client* c, uint8_t op, int dtype, const char* name,
                      const uint32_t* rows, uint32_t n_rows,
                      const void* payload, uint64_t payload_len,
                      void* out, uint64_t out_cap_bytes) {
  std::lock_guard<std::mutex> lk(c->mu);
  int retries = rpc_retry_times();
  for (int attempt = 0; ; attempt++) {
    bool sent = false;
    int64_t n = request_once(c, op, dtype, name, rows, n_rows, payload,
                             payload_len, out, out_cap_bytes, &sent);
    if (n >= 0 || n == -2) return n;
    // transport failure: after a timeout the stream is desynced —
    // reconnect before any retry.  A CRC reject (-3) was verifiably NOT
    // applied server-side, so it is safe to resend for any op.
    bool may_have_applied = sent && n != -3;
    if (attempt >= retries ||
        (may_have_applied && !op_idempotent(op)))
      return -1;
    std::this_thread::sleep_for(
        std::chrono::milliseconds(100L << std::min(attempt, 6)));
    if (c->fd >= 0) ::close(c->fd);
    c->fd = connect_fd(c->host, c->port, c->deadline_ms, 1);
    // c->fd may still be -1: the next attempt fails fast (write to a
    // bad fd) and the loop backs off again until retries run out
  }
}

int64_t request(Client* c, uint8_t op, const char* name,
                const uint32_t* rows, uint32_t n_rows, const float* payload,
                uint64_t n_floats, float* out, int64_t out_cap) {
  int64_t nb = request_bytes(c, op, -1, name, rows, n_rows, payload,
                             n_floats * sizeof(float), out,
                             static_cast<uint64_t>(out_cap) * 4);
  return nb < 0 ? nb : nb / static_cast<int64_t>(sizeof(float));
}
}  // namespace

int ps_client_put(void* h, const char* name, const float* data, int64_t n) {
  return request(static_cast<Client*>(h), kPut, name, nullptr, 0, data,
                 static_cast<uint64_t>(n), nullptr, 0) >= 0 ? 0 : -1;
}

int64_t ps_client_get(void* h, const char* name, float* out, int64_t cap) {
  return request(static_cast<Client*>(h), kGet, name, nullptr, 0, nullptr, 0,
                 out, cap);
}

int64_t ps_client_get_nobarrier(void* h, const char* name, float* out,
                                int64_t cap) {
  return request(static_cast<Client*>(h), kGetNoBarrier, name, nullptr, 0,
                 nullptr, 0, out, cap);
}

int ps_client_push_dense(void* h, const char* name, const float* grad,
                         int64_t n) {
  return request(static_cast<Client*>(h), kPushDense, name, nullptr, 0, grad,
                 static_cast<uint64_t>(n), nullptr, 0) >= 0 ? 0 : -1;
}

int ps_client_push_sparse(void* h, const char* name, const uint32_t* rows,
                          uint32_t n_rows, const float* grad, int64_t n) {
  return request(static_cast<Client*>(h), kPushSparse, name, rows, n_rows,
                 grad, static_cast<uint64_t>(n), nullptr, 0) >= 0 ? 0 : -1;
}

int64_t ps_client_get_rows(void* h, const char* name, const uint32_t* rows,
                           uint32_t n_rows, float* out, int64_t cap) {
  return request(static_cast<Client*>(h), kGetRows, name, rows, n_rows,
                 nullptr, 0, out, cap);
}

// ---- typed tables (dtype: 0 f32, 1 bf16, 2 int64) ----------------------

int ps_client_put_typed(void* h, const char* name, const void* data,
                        int64_t n_elems, int dtype) {
  return request_bytes(static_cast<Client*>(h), kPutTyped, dtype, name,
                       nullptr, 0, data,
                       static_cast<uint64_t>(n_elems) *
                           dtype_size(static_cast<uint8_t>(dtype)),
                       nullptr, 0) >= 0 ? 0 : -1;
}

int64_t ps_client_get_typed(void* h, const char* name, void* out,
                            int64_t cap_elems, int dtype) {
  size_t esz = dtype_size(static_cast<uint8_t>(dtype));
  int64_t nb = request_bytes(static_cast<Client*>(h), kGetTyped, dtype,
                             name, nullptr, 0, nullptr, 0, out,
                             static_cast<uint64_t>(cap_elems) * esz);
  return nb < 0 ? nb : nb / static_cast<int64_t>(esz);
}

int ps_client_push_typed(void* h, const char* name, const uint32_t* rows,
                         uint32_t n_rows, const void* data, int64_t n_elems,
                         int dtype) {
  return request_bytes(static_cast<Client*>(h), kPushTyped, dtype, name,
                       rows, n_rows, data,
                       static_cast<uint64_t>(n_elems) *
                           dtype_size(static_cast<uint8_t>(dtype)),
                       nullptr, 0) >= 0 ? 0 : -1;
}

// Register a typed table server-side before start (dense size or
// rows×width like ps_server_add_param); init points at `size` elements
// of `dtype`.
int ps_server_add_param_typed(void* h, const char* name, int64_t size,
                              const void* init, int dtype, int optim,
                              float lr, float hp1, float hp2, int64_t rows) {
  Server* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  Param& p = s->table[name];
  p.dtype = static_cast<uint8_t>(dtype);
  if (p.dtype == kI64) {
    const int64_t* src = static_cast<const int64_t*>(init);
    p.vi64.assign(src, src + size);
  } else if (p.dtype == kBF16) {
    const uint16_t* src = static_cast<const uint16_t*>(init);
    p.value.resize(size);
    for (int64_t i = 0; i < size; i++) p.value[i] = bf16_to_f32(src[i]);
  } else {
    const float* src = static_cast<const float*>(init);
    p.value.assign(src, src + size);
  }
  p.optim = optim;
  p.lr = lr;
  if (optim == kMomentum) p.mom = hp1;
  if (optim == kAdam) { p.beta1 = hp1; p.beta2 = hp2; }
  p.rows = rows;
  p.width = rows > 0 ? size / rows : size;
  return 0;
}

int ps_client_barrier(void* h) {
  return request(static_cast<Client*>(h), kBarrier, "", nullptr, 0, nullptr,
                 0, nullptr, 0) >= 0 ? 0 : -1;
}

int ps_client_stop_server(void* h) {
  return request(static_cast<Client*>(h), kStop, "", nullptr, 0, nullptr, 0,
                 nullptr, 0) >= 0 ? 0 : -1;
}

void ps_client_destroy(void* h) {
  Client* c = static_cast<Client*>(h);
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

// test/tooling hook: the frame CRC (native_test.cc locks it against the
// published IEEE check value so both wire ends share one implementation)
uint32_t ptn_crc32(uint32_t crc, const void* buf, uint64_t n) {
  return crc32_update(crc, buf, static_cast<size_t>(n));
}

}  // extern "C"
