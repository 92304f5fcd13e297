// Native rank-0 coordinator: TCP negotiation server.
//
// The C++ equivalent of the reference's C++ controller/background core
// (reference: common/controller.cc ComputeResponseList/:471-748
// ConstructResponse/:777-914 FuseResponses + the transport loops of
// mpi_controller.cc / gloo_controller.cc), rebuilt for the TPU
// framework's event-driven TCP protocol.  Speaks the exact wire format
// of horovod_tpu/common/message.py, so Python workers connect to it
// unchanged; the Python CoordinatorServer remains as a fallback when
// the shared library is unavailable.
//
// Implements the response-cache fast path (reference:
// response_cache.{h,cc}, fast path controller.cc:81-236) with
// coordinator-authoritative bit assignment: steady-state steps exchange
// 4-byte cache bits (CH uplink / CB downlink) instead of full
// request/response lists.  Also: group-atomic fusion (reference
// group_table.{h,cc}, controller.cc:199-223) and rank-0 stall
// attribution (reference stall_inspector.h:74-80).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -pthread coordinator.cc
//            -o libhvdtpu_coord.so
//
// C API (ctypes):
//   void* hvd_coord_create(int size, const char* bind_addr, int port,
//                          long long fusion_threshold, int elastic,
//                          int allow_ephemeral, int cache_capacity,
//                          double stall_warn_s, double stall_shutdown_s);
//   int   hvd_coord_port(void*);
//   void  hvd_coord_set_fusion(void*, long long);
//   void  hvd_coord_stats(void*, long long* rounds, long long* bytes);
//   void  hvd_coord_cache_stats(void*, long long* fast_rounds,
//                               long long* full_rounds);
//   int   hvd_coord_drain_round_bytes(void*, long long* out, int cap);
//   int   hvd_coord_stall_report(void*, char* buf, int cap);
//   void  hvd_coord_counts(void*, int* seen, int* departed);
//   void  hvd_coord_stop(void*);

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <list>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// wire protocol (mirrors message.py exactly; little-endian, packed)
// ---------------------------------------------------------------------
enum ReqType : int32_t {
  REQ_ALLREDUCE = 0, REQ_ALLGATHER = 1, REQ_BROADCAST = 2, REQ_JOIN = 3,
  REQ_ADASUM = 4, REQ_ALLTOALL = 5, REQ_REDUCESCATTER = 6,
  REQ_BARRIER = 7,
};
enum RespType : int32_t {
  RESP_ALLREDUCE = 0, RESP_ALLGATHER = 1, RESP_BROADCAST = 2,
  RESP_JOIN = 3, RESP_ADASUM = 4, RESP_ALLTOALL = 5,
  RESP_REDUCESCATTER = 6, RESP_BARRIER = 7, RESP_ERROR = 8,
};

const int kDtypeSize[] = {1, 1, 2, 2, 4, 8, 2, 4, 8, 1, 2};

struct Request {
  int32_t rank = 0;
  int32_t type = 0;
  int32_t dtype = 7;
  int32_t root = -1;
  int32_t device = 0;
  double prescale = 1.0;
  double postscale = 1.0;
  int32_t psid = 0;
  int32_t group_id = -1;
  std::vector<int64_t> shape;
  std::string name;
  std::string op;
  std::vector<int32_t> psr;  // process-set member ranks
  // Alltoall send splits (group order) — assembled into the response's
  // sizes matrix so the data plane skips its own split exchange
  // (mirrors message.py Request.splits; reference
  // AlltoallGetRecvSplits, mpi_controller.cc:212-223).
  std::vector<int64_t> splits;
};

struct Response {
  int32_t type = 0;
  int32_t dtype = 7;
  double prescale = 1.0;
  double postscale = 1.0;
  int32_t psid = 0;
  int32_t root = -1;
  int32_t last_joined = -1;
  std::vector<std::string> names;
  std::vector<int64_t> sizes;
  std::string error;
  std::string op = "Sum";
  std::vector<std::vector<int64_t>> shapes;
  std::vector<int32_t> psr;
  std::vector<int32_t> cache_bits;
};

class Reader {
 public:
  Reader(const uint8_t* d, size_t n) : d_(d), n_(n) {}
  template <typename T> T get() {
    T v;
    std::memcpy(&v, d_ + off_, sizeof(T));
    off_ += sizeof(T);
    return v;
  }
  std::string str(size_t len) {
    std::string s(reinterpret_cast<const char*>(d_ + off_), len);
    off_ += len;
    return s;
  }
  bool ok(size_t need) const { return off_ + need <= n_; }
  size_t off() const { return off_; }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t off_ = 0;
};

class Writer {
 public:
  template <typename T> void put(T v) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
    buf_.insert(buf_.end(), p, p + sizeof(T));
  }
  void str(const std::string& s) {
    buf_.insert(buf_.end(), s.begin(), s.end());
  }
  std::vector<uint8_t>& data() { return buf_; }

 private:
  std::vector<uint8_t> buf_;
};

bool parse_request(const uint8_t* d, size_t n, Request* r) {
  // head "<iiiiiddiiiHHHH" = 56 bytes
  if (n < 56) return false;
  Reader rd(d, n);
  r->rank = rd.get<int32_t>();
  r->type = rd.get<int32_t>();
  r->dtype = rd.get<int32_t>();
  r->root = rd.get<int32_t>();
  r->device = rd.get<int32_t>();
  r->prescale = rd.get<double>();
  r->postscale = rd.get<double>();
  r->psid = rd.get<int32_t>();
  r->group_id = rd.get<int32_t>();
  int32_t ndim = rd.get<int32_t>();
  uint16_t name_len = rd.get<uint16_t>();
  uint16_t op_len = rd.get<uint16_t>();
  uint16_t n_psr = rd.get<uint16_t>();
  uint16_t n_splits = rd.get<uint16_t>();
  if (!rd.ok(size_t(ndim) * 8 + name_len + op_len +
             size_t(n_psr) * 4 + size_t(n_splits) * 8))
    return false;
  r->shape.resize(ndim);
  for (int i = 0; i < ndim; ++i) r->shape[i] = rd.get<int64_t>();
  r->name = rd.str(name_len);
  r->op = rd.str(op_len);
  r->psr.resize(n_psr);
  for (int i = 0; i < n_psr; ++i) r->psr[i] = rd.get<int32_t>();
  r->splits.resize(n_splits);
  for (int i = 0; i < n_splits; ++i) r->splits[i] = rd.get<int64_t>();
  return true;
}

std::vector<uint8_t> serialize_response(const Response& r) {
  Writer w;
  w.put<int32_t>(r.type);
  w.put<int32_t>(r.dtype);
  w.put<double>(r.prescale);
  w.put<double>(r.postscale);
  w.put<int32_t>(r.psid);
  w.put<int32_t>(r.root);
  w.put<int32_t>(r.last_joined);
  w.put<uint16_t>(uint16_t(r.names.size()));
  // uint32: alltoall piggybacks a group^2 split matrix here, which
  // overflows uint16 at 256-rank groups (mirrors message.py "<...I...>").
  w.put<uint32_t>(uint32_t(r.sizes.size()));
  w.put<uint16_t>(uint16_t(r.error.size()));
  w.put<uint16_t>(uint16_t(r.op.size()));
  w.put<uint16_t>(uint16_t(r.shapes.size()));
  w.put<uint16_t>(uint16_t(r.psr.size()));
  w.put<uint16_t>(uint16_t(r.cache_bits.size()));
  for (const auto& n : r.names) {
    w.put<uint16_t>(uint16_t(n.size()));
    w.str(n);
  }
  for (int64_t s : r.sizes) w.put<int64_t>(s);
  w.str(r.error);
  w.str(r.op);
  for (const auto& sh : r.shapes) {
    w.put<uint16_t>(uint16_t(sh.size()));
    for (int64_t d : sh) w.put<int64_t>(d);
  }
  for (int32_t p : r.psr) w.put<int32_t>(p);
  for (int32_t b : r.cache_bits) w.put<int32_t>(b);
  return std::move(w.data());
}

std::vector<uint8_t> pack_response_list(const std::vector<Response>& rs) {
  Writer w;
  w.put<uint8_t>(0);  // shutdown flag
  w.put<uint32_t>(uint32_t(rs.size()));
  for (const auto& r : rs) {
    auto b = serialize_response(r);
    w.put<uint32_t>(uint32_t(b.size()));
    w.data().insert(w.data().end(), b.begin(), b.end());
  }
  return std::move(w.data());
}

std::vector<uint8_t> pack_bits(const std::vector<int32_t>& bits) {
  Writer w;
  w.put<uint32_t>(uint32_t(bits.size()));
  for (int32_t b : bits) w.put<uint32_t>(uint32_t(b));
  return std::move(w.data());
}

std::vector<uint8_t> pack_bit_batches(
    const std::vector<std::vector<int32_t>>& batches) {
  Writer w;
  w.put<uint32_t>(uint32_t(batches.size()));
  for (const auto& batch : batches) {
    w.put<uint32_t>(uint32_t(batch.size()));
    for (int32_t b : batch) w.put<uint32_t>(uint32_t(b));
  }
  return std::move(w.data());
}

bool unpack_bits(const uint8_t* d, size_t n, std::vector<int32_t>* out) {
  if (n < 4) return false;
  uint32_t count;
  std::memcpy(&count, d, 4);
  if (n < 4 + size_t(count) * 4) return false;
  out->resize(count);
  for (uint32_t i = 0; i < count; ++i) {
    uint32_t v;
    std::memcpy(&v, d + 4 + i * 4, 4);
    (*out)[i] = int32_t(v);
  }
  return true;
}

// ---------------------------------------------------------------------
// socket helpers
// ---------------------------------------------------------------------
bool send_all(int fd, const uint8_t* d, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t k = ::send(fd, d + off, n - off, MSG_NOSIGNAL);
    if (k <= 0) return false;
    off += size_t(k);
  }
  return true;
}

bool send_frame(int fd, const char magic[2],
                const std::vector<uint8_t>& payload) {
  uint8_t head[6];
  head[0] = magic[0];
  head[1] = magic[1];
  uint32_t len = uint32_t(payload.size());
  std::memcpy(head + 2, &len, 4);
  if (!send_all(fd, head, 6)) return false;
  return send_all(fd, payload.data(), payload.size());
}

bool recv_exact(int fd, uint8_t* d, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t k = ::recv(fd, d + off, n - off, 0);
    if (k <= 0) return false;
    off += size_t(k);
  }
  return true;
}

bool recv_frame(int fd, char magic[2], std::vector<uint8_t>* payload) {
  uint8_t head[6];
  if (!recv_exact(fd, head, 6)) return false;
  magic[0] = char(head[0]);
  magic[1] = char(head[1]);
  uint32_t len;
  std::memcpy(&len, head + 2, 4);
  if (len > (256u << 20)) return false;  // sanity bound
  payload->resize(len);
  return len == 0 || recv_exact(fd, payload->data(), len);
}

// ---------------------------------------------------------------------
// negotiation logic (mirrors controller.py + controller_net.py)
// ---------------------------------------------------------------------
const std::set<int32_t> kFusable = {RESP_ALLREDUCE, RESP_ADASUM,
                                    RESP_ALLGATHER, RESP_REDUCESCATTER};
// ALLTOALL is excluded (round 5): its response carries the send-split
// matrix, and splits may change call-to-call under an unchanged
// signature — a cached response would serve stale recv splits
// (mirrors response_cache.py CACHEABLE).
const std::set<int32_t> kCacheable = {RESP_ALLREDUCE, RESP_ADASUM,
                                      RESP_ALLGATHER, RESP_BROADCAST,
                                      RESP_REDUCESCATTER};

Response construct_response(const std::string& name,
                            const std::vector<Request>& msgs, int size) {
  const Request& first = msgs[0];
  std::string err;
  for (size_t i = 1; i < msgs.size() && err.empty(); ++i) {
    const Request& m = msgs[i];
    if (m.type != first.type)
      err = "Mismatched collective operations for tensor " + name + ".";
    else if (m.dtype != first.dtype)
      err = "Mismatched data types for tensor " + name + ".";
    else if (m.op != first.op)
      err = "Mismatched reduction ops for tensor " + name + ".";
    else if (m.prescale != first.prescale ||
             m.postscale != first.postscale)
      err = "Mismatched prescale/postscale factors for tensor " + name +
            ".";
    else if (first.type == REQ_BROADCAST && m.root != first.root)
      err = "Mismatched broadcast root ranks for tensor " + name + ".";
    else if ((first.type == REQ_ALLREDUCE || first.type == REQ_ADASUM ||
              first.type == REQ_BROADCAST) &&
             m.shape != first.shape)
      err = "Mismatched shapes for tensor " + name + ".";
    else if (first.type == REQ_ALLGATHER ||
             first.type == REQ_ALLTOALL ||
             first.type == REQ_REDUCESCATTER) {
      if (m.shape.size() != first.shape.size() ||
          (m.shape.size() > 1 &&
           !std::equal(m.shape.begin() + 1, m.shape.end(),
                       first.shape.begin() + 1)))
        err = "Mismatched non-first dimensions for tensor " + name + ".";
    }
  }
  if (err.empty() && first.type == REQ_ALLTOALL) {
    size_t group = first.psr.empty() ? size_t(size) : first.psr.size();
    for (const auto& m : msgs) {
      // 0-d tensors are promoted to one row by the data plane.
      int64_t dim0 = m.shape.empty() ? 1 : m.shape[0];
      if (m.splits.size() != group) {
        err = "Alltoall splits for tensor " + name + ": rank " +
              std::to_string(m.rank) + " sent " +
              std::to_string(m.splits.size()) + " entries for a group "
              "of " + std::to_string(group) + ".";
        break;
      }
      int64_t sum = 0;
      bool neg = false;
      for (int64_t s : m.splits) { sum += s; neg = neg || s < 0; }
      if (neg) {
        err = "Alltoall splits for tensor " + name + ": rank " +
              std::to_string(m.rank) + " sent negative splits.";
        break;
      }
      if (sum != dim0) {
        // Wire parity with the Python coordinator: name the rank and
        // both sums (ragged lookup batches hit this).
        err = "Alltoall splits for tensor " + name + ": rank " +
              std::to_string(m.rank) + " splits sum to " +
              std::to_string(sum) + " but must sum to the first "
              "dimension (" + std::to_string(dim0) + ").";
        break;
      }
    }
  }
  if (!err.empty()) {
    Response r;
    r.type = RESP_ERROR;
    r.names = {name};
    r.error = err;
    r.psid = first.psid;
    return r;
  }
  Response r;
  r.type = first.type;  // enum values align 1:1
  r.names = {name};
  r.dtype = first.dtype;
  r.prescale = first.prescale;
  r.postscale = first.postscale;
  r.psid = first.psid;
  r.root = first.root;
  r.op = first.op;
  r.shapes = {first.shape};
  r.psr = first.psr;
  if (first.type == REQ_ALLGATHER) {
    // Per-rank first-dim sizes in GROUP order (process-set ranks when
    // given, else world order) — consumers slice tensor_sizes in
    // group_size strides (mirrors controller.py construct_response).
    std::map<int32_t, const Request*> by_rank;
    for (const auto& m : msgs) by_rank[m.rank] = &m;
    std::vector<int32_t> ranks;
    if (!first.psr.empty())
      ranks.assign(first.psr.begin(), first.psr.end());
    else
      for (int rk = 0; rk < size; ++rk) ranks.push_back(rk);
    for (int rk : ranks) {
      auto it = by_rank.find(rk);
      if (it != by_rank.end()) {
        const auto& sh = it->second->shape;
        r.sizes.push_back(sh.empty() ? 1 : sh[0]);
      } else {
        r.sizes.push_back(0);  // joined (departed) rank: zero rows
      }
    }
  } else if (first.type == REQ_ALLTOALL) {
    // Flattened group×group send-split matrix, rows in GROUP order —
    // rank g's recv splits are column g (mirrors controller.py;
    // reference AlltoallGetRecvSplits, mpi_controller.cc:212-223).
    std::map<int32_t, const Request*> by_rank;
    for (const auto& m : msgs) by_rank[m.rank] = &m;
    std::vector<int32_t> ranks;
    if (!first.psr.empty())
      ranks.assign(first.psr.begin(), first.psr.end());
    else
      for (int rk = 0; rk < size; ++rk) ranks.push_back(rk);
    for (int rk : ranks) {
      auto it = by_rank.find(rk);
      if (it != by_rank.end()) {
        for (int64_t s : it->second->splits) r.sizes.push_back(s);
      } else {
        for (size_t i = 0; i < ranks.size(); ++i) r.sizes.push_back(0);
      }
    }
  }
  return r;
}

// Request signature: everything that must match for a cached response
// to remain valid (mirrors response_cache.py request_signature).
struct Sig {
  std::vector<int64_t> shape;
  int32_t dtype = 7;
  int32_t root = -1;
  double prescale = 1.0;
  double postscale = 1.0;
  int32_t psid = 0;
  std::string op;
  int32_t rtype = 0;
  std::vector<int32_t> psr;
};

Sig make_sig(const Request& r) {
  Sig s;
  s.shape = r.shape;
  s.dtype = r.dtype;
  s.root = r.root;
  s.prescale = r.prescale;
  s.postscale = r.postscale;
  s.psid = r.psid;
  s.op = r.op;
  s.rtype = r.type;
  s.psr = r.psr;
  return s;
}

Request sig_to_request(const Sig& s, int rank, const std::string& name,
                       int64_t first_dim /* -1 = keep */) {
  Request r;
  r.rank = rank;
  r.type = s.rtype;
  r.name = name;
  r.shape = s.shape;
  if (first_dim >= 0 && !r.shape.empty()) r.shape[0] = first_dim;
  r.dtype = s.dtype;
  r.root = s.root;
  r.prescale = s.prescale;
  r.postscale = s.postscale;
  r.psid = s.psid;
  r.op = s.op;
  r.psr = s.psr;
  return r;
}

// Coordinator-side response cache with authoritative, monotonically
// increasing bit assignment (see response_cache.py CoordinatorCache).
// Per-tensor coordinator state (message table, caches, stall clocks)
// is keyed by process set AND name: the same tensor name may be in
// flight on two process sets at once (the reference allows this
// structurally — every process set owns its own controller,
// process_set.h ProcessSetTable).  Key format "<psid>\x1f<name>";
// \x1f cannot appear in the psid digits, so the FIRST separator
// always recovers the pure wire name even if the name itself
// contains \x1f.
inline std::string ps_key(int32_t psid, const std::string& name) {
  return std::to_string(psid) + '\x1f' + name;
}
inline std::string pure_name(const std::string& key) {
  auto pos = key.find('\x1f');
  return pos == std::string::npos ? key : key.substr(pos + 1);
}
inline int32_t key_psid(const std::string& key) {
  auto pos = key.find('\x1f');
  if (pos == std::string::npos) return 0;
  return int32_t(std::atoi(key.substr(0, pos).c_str()));
}

class CoordCache {
 public:
  struct Entry {
    int32_t bit;
    Response resp;  // per-tensor
    Sig sig;
    int32_t gid;
  };
  struct Tomb {
    std::string name;
    Sig sig;
    std::vector<int64_t> sizes;
    int32_t gid;
  };

  explicit CoordCache(int capacity) : capacity_(capacity) {}

  bool enabled() const { return capacity_ > 0; }
  bool has(const std::string& name) const { return entries_.count(name); }
  Entry* get(const std::string& name) {
    auto it = entries_.find(name);
    return it == entries_.end() ? nullptr : &it->second;
  }

  // Returns 0 = unknown, 1 = live, 2 = tombstone.
  int resolve_bit(int32_t bit, std::string* name, Sig* sig,
                  std::vector<int64_t>* sizes, int32_t* gid) {
    auto it = bit_names_.find(bit);
    if (it != bit_names_.end()) {
      Entry& e = entries_[it->second];
      // LRU: a bit contribution marks the tensor hot, so capacity
      // eviction prefers tensors no rank is actively using
      // (response_cache.py resolve_bit; reference response_cache.h
      // LRU semantics).  O(1) splice — this runs once per cached
      // tensor per step on the coordinator thread.
      touch_order(it->second);
      *name = it->second;
      *sig = e.sig;
      *sizes = e.resp.sizes;
      *gid = e.gid;
      return 1;
    }
    auto tit = tombstones_.find(bit);
    if (tit != tombstones_.end()) {
      *name = tit->second.name;
      *sig = tit->second.sig;
      *sizes = tit->second.sizes;
      *gid = tit->second.gid;
      return 2;
    }
    return 0;
  }

  int32_t insert(const std::string& name, const Response& resp,
                 const Sig& sig, int32_t gid,
                 const std::set<std::string>& pending,
                 std::vector<int32_t>* evicted) {
    auto it = entries_.find(name);
    if (it != entries_.end()) {
      tombstone(it->second.bit, name, it->second.sig,
                it->second.resp.sizes, it->second.gid);
      bit_names_.erase(it->second.bit);
      evicted->push_back(it->second.bit);
      remove_order(name);
      entries_.erase(it);
    }
    while (int(entries_.size()) >= capacity_ && capacity_ > 0) {
      std::string victim;
      for (const auto& cand : order_) {
        if (!pending.count(cand)) {
          victim = cand;
          break;
        }
      }
      if (victim.empty()) break;  // everything in flight; overgrow
      Entry& e = entries_[victim];
      tombstone(e.bit, victim, e.sig, e.resp.sizes, e.gid);
      bit_names_.erase(e.bit);
      evicted->push_back(e.bit);
      entries_.erase(victim);
      remove_order(victim);
    }
    int32_t bit = next_bit_++;
    entries_[name] = Entry{bit, resp, sig, gid};
    order_.push_back(name);
    order_it_[name] = std::prev(order_.end());
    bit_names_[bit] = name;
    return bit;
  }

  // Evict by name (full request arrived for a cached tensor); returns
  // the freed bit or -1.
  int32_t evict_name(const std::string& name) {
    auto it = entries_.find(name);
    if (it == entries_.end()) return -1;
    int32_t bit = it->second.bit;
    tombstone(bit, name, it->second.sig, it->second.resp.sizes,
              it->second.gid);
    bit_names_.erase(bit);
    entries_.erase(it);
    remove_order(name);
    return bit;
  }

  void clear_tombstones_for(const std::string& name) {
    for (auto it = tombstones_.begin(); it != tombstones_.end();) {
      if (it->second.name == name)
        it = tombstones_.erase(it);
      else
        ++it;
    }
  }

 private:
  void tombstone(int32_t bit, const std::string& name, const Sig& sig,
                 const std::vector<int64_t>& sizes, int32_t gid) {
    tombstones_[bit] = Tomb{name, sig, sizes, gid};
    tomb_order_.push_back(bit);
    while (tomb_order_.size() > 65536) {
      tombstones_.erase(tomb_order_.front());
      tomb_order_.pop_front();
    }
  }
  void remove_order(const std::string& name) {
    auto it = order_it_.find(name);
    if (it == order_it_.end()) return;
    order_.erase(it->second);
    order_it_.erase(it);
  }

  // Move to the most-recently-used end in O(1).
  void touch_order(const std::string& name) {
    auto it = order_it_.find(name);
    if (it == order_it_.end()) return;
    order_.splice(order_.end(), order_, it->second);
    it->second = std::prev(order_.end());
  }

  int capacity_;
  std::map<std::string, Entry> entries_;
  std::list<std::string> order_;  // LRU order, front = coldest
  std::map<std::string, std::list<std::string>::iterator> order_it_;
  std::map<int32_t, std::string> bit_names_;
  std::map<int32_t, Tomb> tombstones_;
  std::deque<int32_t> tomb_order_;
  int32_t next_bit_ = 0;
};

class Coordinator {
 public:
  Coordinator(int size, const std::string& bind_addr, int port,
              int64_t fusion_threshold, bool elastic,
              bool allow_ephemeral, int cache_capacity,
              double stall_warn_s, double stall_shutdown_s)
      : size_(size),
        fusion_threshold_(fusion_threshold),
        elastic_(elastic),
        cache_(cache_capacity),
        formed_(size <= 1),
        stall_warn_s_(stall_warn_s),
        stall_shutdown_s_(stall_shutdown_s) {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return;
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(uint16_t(port));
    addr.sin_addr.s_addr =
        bind_addr.empty() ? INADDR_ANY : ::inet_addr(bind_addr.c_str());
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0) {
      if (!allow_ephemeral) {
        ::close(listen_fd_);
        listen_fd_ = -1;
        return;
      }
      addr.sin_port = 0;
      if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr),
                 sizeof(addr)) != 0) {
        ::close(listen_fd_);
        listen_fd_ = -1;
        return;
      }
    }
    ::listen(listen_fd_, size + 4);
    sockaddr_in bound{};
    socklen_t blen = sizeof(bound);
    ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&bound), &blen);
    port_ = ntohs(bound.sin_port);
    accept_thread_ = std::thread([this] { AcceptLoop(); });
    if (stall_warn_s_ > 0)
      stall_thread_ = std::thread([this] { StallLoop(); });
  }

  bool valid() const { return listen_fd_ >= 0; }
  int port() const { return port_; }

  void set_fusion(int64_t v) { fusion_threshold_.store(v); }

  void stats(int64_t* rounds, int64_t* bytes) {
    *rounds = rounds_.load();
    *bytes = bytes_.load();
  }

  void cache_stats(int64_t* fast, int64_t* full) {
    *fast = fast_rounds_.load();
    *full = full_rounds_.load();
  }

  // Drain up to `cap` per-round fused-byte values since the last call.
  // Gives the autotuner the true per-round distribution (the GP models
  // per-round throughput; a flat average would collapse its variance).
  // Single consumer: only the host poll thread calls this. On overflow
  // the oldest rounds are dropped.
  int DrainRoundBytes(int64_t* out, int cap) {
    // Overflow clamp keeps half the ring as a safety margin: clamping
    // to exactly w - kRoundRing would put the read cursor on the slot
    // the writer fills next, and a commit racing the drain loop would
    // hand the autotuner a torn int64.  Both the clamp and the
    // published write cursor are re-evaluated EVERY iteration: a
    // single snapshot of round_w_ would let a committer lapping the
    // reader mid-loop overwrite slots the stale clamp still considered
    // safe (torn values fed to the autotuner).
    int n = 0;
    while (n < cap) {
      int64_t w = round_w_.load(std::memory_order_acquire);
      if (w - round_r_ > kRoundRing / 2) round_r_ = w - kRoundRing / 2;
      if (round_r_ >= w) break;
      out[n++] = round_bytes_[round_r_ % kRoundRing];
      ++round_r_;
    }
    return n;
  }

  // Human-readable stall attribution, one line per stalled tensor.
  std::string StallReport() {
    std::string out;
    auto now = std::chrono::steady_clock::now();
    std::lock_guard<std::mutex> g(mu_);
    for (const auto& kv : table_) {
      if (kv.second.empty()) continue;
      auto ts = first_seen_.find(kv.first);
      if (ts == first_seen_.end()) continue;
      double age =
          std::chrono::duration<double>(now - ts->second).count();
      if (age < stall_warn_s_) continue;
      std::set<int32_t> submitted;
      for (const auto& m : kv.second) submitted.insert(m.rank);
      std::vector<int32_t> members;
      if (!kv.second[0].psr.empty())
        members = kv.second[0].psr;
      else
        for (int r = 0; r < size_; ++r) members.push_back(r);
      std::string sub, miss;
      for (int32_t r : submitted) sub += std::to_string(r) + ",";
      for (int32_t r : members)
        if (!submitted.count(r) && !joined_.count(r))
          miss += std::to_string(r) + ",";
      if (!sub.empty()) sub.pop_back();
      if (!miss.empty()) miss.pop_back();
      char line[512];
      std::snprintf(line, sizeof(line),
                    "STALL: tensor %s - ranks [%s] submitted, ranks "
                    "[%s] have not, for %.0fs\n",
                    pure_name(kv.first).c_str(), sub.c_str(),
                    miss.c_str(), age);
      out += line;
    }
    return out;
  }

  void Stop() {
    if (stop_.exchange(true)) return;  // idempotent (also ~Coordinator)
    if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      listen_fd_ = -1;
    }
    {
      std::lock_guard<std::mutex> g(mu_);
      for (auto& kv : conns_) {
        ::shutdown(kv.second, SHUT_RDWR);
        ::close(kv.second);
      }
      conns_.clear();
    }
    stall_cv_.notify_all();
    if (accept_thread_.joinable()) accept_thread_.join();
    if (stall_thread_.joinable()) stall_thread_.join();
    for (auto& t : rank_threads_)
      if (t.joinable()) t.join();
  }

  ~Coordinator() { Stop(); }

 private:
  void AcceptLoop() {
    while (!stop_.load()) {
      pollfd pfd{listen_fd_, POLLIN, 0};
      int rc = ::poll(&pfd, 1, 500);
      if (stop_.load()) return;
      if (rc <= 0) continue;
      int conn = ::accept(listen_fd_, nullptr, nullptr);
      if (conn < 0) continue;
      int one = 1;
      ::setsockopt(conn, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      // First frame: rank id.
      char magic[2];
      std::vector<uint8_t> payload;
      if (!recv_frame(conn, magic, &payload) || payload.size() < 4) {
        ::close(conn);
        continue;
      }
      int32_t rank;
      std::memcpy(&rank, payload.data(), 4);
      {
        std::lock_guard<std::mutex> g(mu_);
        conns_[rank] = conn;
        if (!formed_ && int(conns_.size()) >= size_) {
          formed_ = true;
          std::vector<PreItem> pre;
          pre.swap(pre_formed_);
          for (auto& p : pre) {
            if (p.is_hits) {
              HandleCacheHitsLocked(p.rank, p.bits);
            } else {
              std::vector<std::pair<Request, bool>> items;
              items.reserve(p.reqs.size());
              for (auto& r : p.reqs) items.emplace_back(std::move(r),
                                                        false);
              Process(p.rank, items);
            }
          }
        }
      }
      {
        std::lock_guard<std::mutex> g(departed_mu_);
        ++seen_;
      }
      rank_threads_.emplace_back(
          [this, rank, conn] { RankLoop(rank, conn); });
    }
  }

  void RankLoop(int rank, int conn) {
    bool clean = false;
    char magic[2];
    std::vector<uint8_t> payload;
    while (!stop_.load()) {
      if (!recv_frame(conn, magic, &payload)) break;
      if (magic[0] == 'C' && magic[1] == 'H') {
        std::vector<int32_t> bits;
        if (!unpack_bits(payload.data(), payload.size(), &bits)) break;
        HandleCacheHits(rank, bits);
        continue;
      }
      if (payload.size() < 5) break;
      uint8_t shutdown_flag = payload[0];
      if (shutdown_flag) {
        clean = true;
        break;
      }
      uint32_t count;
      std::memcpy(&count, payload.data() + 1, 4);
      std::vector<Request> reqs;
      size_t off = 5;
      bool ok = true;
      for (uint32_t i = 0; i < count && ok; ++i) {
        if (off + 4 > payload.size()) {
          ok = false;
          break;
        }
        uint32_t len;
        std::memcpy(&len, payload.data() + off, 4);
        off += 4;
        if (off + len > payload.size()) {
          ok = false;
          break;
        }
        Request r;
        if (!parse_request(payload.data() + off, len, &r)) {
          ok = false;
          break;
        }
        off += len;
        reqs.push_back(std::move(r));
      }
      if (!ok) break;
      HandleRequests(rank, reqs);
    }
    {
      std::lock_guard<std::mutex> g(departed_mu_);
      ++departed_;
      departed_cv_.notify_all();
    }
    if (!stop_.load()) OnRankLost(rank, clean);
  }

 public:
  void DepartureCounts(int* seen, int* departed) {
    std::lock_guard<std::mutex> g(departed_mu_);
    *seen = seen_;
    *departed = departed_;
  }

 private:

  int RequiredFor(const Request& r) const {
    return r.psr.empty() ? size_ : int(r.psr.size());
  }

  int JoinedCountFor(const Request& r) const {
    if (r.psr.empty()) return int(joined_.size());
    int c = 0;
    for (int32_t p : r.psr)
      if (joined_.count(p)) ++c;
    return c;
  }

  // Tensors waiting only on joined (departed) ranks became complete.
  // These must renegotiate in full: a cached response would carry the
  // joined rank's old contribution (e.g. nonzero allgather row
  // counts) whereas construct_response records zeros for it.
  void ScanComplete(
      std::vector<std::pair<std::string, std::vector<Request>>>* ready) {
    std::vector<std::string> done;
    for (auto& kv : table_) {
      if (kv.second.empty()) continue;
      const Request& first = kv.second[0];
      int required = RequiredFor(first);
      if (int(kv.second.size()) + JoinedCountFor(first) >= required) {
        ready->emplace_back(kv.first, kv.second);
        done.push_back(kv.first);
      }
    }
    for (const auto& n : done) {
      table_.erase(n);
      first_seen_.erase(n);
      bit_only_[n] = false;
    }
  }

  int64_t ResponseBytes(const Response& r) {
    int64_t total = 0;
    for (const auto& n : r.names) {
      auto it = elem_cache_.find(ps_key(r.psid, n));
      int64_t elems = it == elem_cache_.end() ? 0 : it->second;
      total += elems * kDtypeSize[r.dtype];
    }
    return total;
  }

  bool CanFuse(const Response& a, const Response& b) {
    if (a.type != b.type) return false;
    if (!kFusable.count(a.type)) return false;
    return a.dtype == b.dtype && a.psid == b.psid &&
           a.prescale == b.prescale && a.postscale == b.postscale &&
           a.op == b.op;
  }

  static void MergeInto(Response* base, const Response& cand) {
    base->names.insert(base->names.end(), cand.names.begin(),
                       cand.names.end());
    base->sizes.insert(base->sizes.end(), cand.sizes.begin(),
                       cand.sizes.end());
    base->shapes.insert(base->shapes.end(), cand.shapes.begin(),
                        cand.shapes.end());
  }

  // Group-atomic pre-merge: members of one grouped submission become a
  // single response BEFORE threshold-bounded fusion, so a group is
  // never split across compiled programs (fusion.py _premerge_groups;
  // reference controller.cc:199-223).
  std::vector<Response> PremergeGroups(std::vector<Response> in) {
    std::vector<Response> merged;
    std::map<std::string, size_t> index;  // group fuse-key -> position
    for (auto& resp : in) {
      int32_t gid = -1;
      if (!resp.names.empty()) {
        auto it = group_ids_.find(ps_key(resp.psid, resp.names[0]));
        if (it != group_ids_.end()) gid = it->second;
      }
      if (gid < 0 || !kFusable.count(resp.type)) {
        merged.push_back(std::move(resp));
        continue;
      }
      char key[160];
      std::snprintf(key, sizeof(key), "%d|%d|%d|%d|%.17g|%.17g|%s", gid,
                    resp.type, resp.dtype, resp.psid, resp.prescale,
                    resp.postscale, resp.op.c_str());
      auto it = index.find(key);
      if (it == index.end()) {
        index[key] = merged.size();
        merged.push_back(std::move(resp));
      } else {
        MergeInto(&merged[it->second], resp);
      }
    }
    return merged;
  }

  // Greedy fusion with look-ahead skip (fusion.py / reference
  // controller.cc:777-914).
  std::vector<Response> Fuse(std::vector<Response> queue) {
    std::vector<Response> out;
    int64_t threshold = fusion_threshold_.load();
    queue = PremergeGroups(std::move(queue));
    while (!queue.empty()) {
      Response base = std::move(queue.front());
      queue.erase(queue.begin());
      if (!kFusable.count(base.type)) {
        out.push_back(std::move(base));
        continue;
      }
      int64_t acc = ResponseBytes(base);
      size_t i = 0;
      while (i < queue.size()) {
        Response& cand = queue[i];
        if (CanFuse(base, cand)) {
          int64_t cb = ResponseBytes(cand);
          if (acc + cb <= threshold) {
            MergeInto(&base, cand);
            acc += cb;
            queue.erase(queue.begin() + i);
            continue;
          }
          break;  // full; keep remaining order intact
        }
        ++i;  // look-ahead skip
      }
      out.push_back(std::move(base));
    }
    return out;
  }

  void BroadcastLocked(const std::vector<Response>& responses) {
    BroadcastFrameLocked("RS", pack_response_list(responses));
  }

  void BroadcastFrameLocked(const char magic[2],
                            const std::vector<uint8_t>& payload) {
    std::vector<int> dead;
    for (auto& kv : conns_) {
      if (!send_frame(kv.second, magic, payload))
        dead.push_back(kv.first);
    }
    for (int r : dead) {
      ::close(conns_[r]);
      conns_.erase(r);
    }
  }

  void FlushEvictionsLocked() {
    if (pending_evictions_.empty()) return;
    BroadcastFrameLocked("EV", pack_bits(pending_evictions_));
    pending_evictions_.clear();
  }

  void HandleRequests(int rank, const std::vector<Request>& reqs) {
    std::lock_guard<std::mutex> g(mu_);
    if (!formed_ && !broken_) {
      // Formation gate: a response completed among early connectors
      // would never reach a not-yet-connected rank (broadcast goes to
      // conns_ only) — buffer until every rank registered (drained in
      // arrival order by AcceptLoop; mirrors controller_net.py).
      PreItem p;
      p.rank = rank;
      p.reqs = reqs;
      pre_formed_.push_back(std::move(p));
      return;
    }
    std::vector<std::pair<Request, bool>> items;
    items.reserve(reqs.size());
    for (const auto& r : reqs) items.emplace_back(r, false);
    Process(rank, items);
  }

  void HandleCacheHits(int rank, const std::vector<int32_t>& bits) {
    std::lock_guard<std::mutex> g(mu_);
    if (!formed_ && !broken_) {  // defense; no bit precedes 1st RS
      PreItem p;
      p.rank = rank;
      p.is_hits = true;
      p.bits = bits;
      pre_formed_.push_back(std::move(p));
      return;
    }
    HandleCacheHitsLocked(rank, bits);
  }

  void HandleCacheHitsLocked(int rank, const std::vector<int32_t>& bits) {
    std::vector<std::pair<Request, bool>> items;
    for (int32_t bit : bits) {
      std::string name;
      Sig sig;
      std::vector<int64_t> sizes;
      int32_t gid;
      int state = cache_.resolve_bit(bit, &name, &sig, &sizes, &gid);
      name = pure_name(name);  // cache keys are ps_key(psid, name)
      if (state == 0) {
        std::fprintf(stderr,
                     "[hvd-coord] unresolvable cache bit %d from rank "
                     "%d; protocol desync\n",
                     bit, rank);
        Response r;
        r.type = RESP_ERROR;
        r.names = {"__cache_bit_" + std::to_string(bit)};
        r.error = "response-cache protocol desync";
        BroadcastLocked({r});
        continue;
      }
      int64_t first_dim = -1;
      if (sig.rtype == REQ_ALLGATHER && !sizes.empty()) {
        // tensor_sizes are in GROUP order: index by the rank's
        // position in the process set when one is given.
        int idx = rank;
        if (!sig.psr.empty()) {
          idx = -1;
          for (size_t gi = 0; gi < sig.psr.size(); ++gi)
            if (sig.psr[gi] == rank) { idx = int(gi); break; }
        }
        if (idx >= 0 && idx < int(sizes.size())) first_dim = sizes[idx];
      }
      Request req = sig_to_request(sig, rank, name, first_dim);
      req.group_id = gid;
      // A tombstoned bit still counts, but forces the full path.
      items.emplace_back(std::move(req), state == 1);
    }
    if (!items.empty()) Process(rank, items);
  }

  void Process(int rank, const std::vector<std::pair<Request, bool>>& items) {
    if (broken_) {
      std::vector<Response> errs;
      for (const auto& it : items) {
        Response r;
        r.type = RESP_ERROR;
        r.names = {it.first.name};
        r.psid = it.first.psid;
        r.error = "membership changed; collective cannot complete";
        errs.push_back(std::move(r));
      }
      if (!errs.empty()) BroadcastLocked(errs);
      return;
    }
    // Completed negotiations and direct (join/barrier) responses, in
    // one ordered list so the broadcast interleaves them exactly as
    // they completed (matching controller_net.py's ready list).
    struct ReadyItem {
      std::string name;           // pure wire name
      std::string key;            // ps_key(psid, name)
      std::vector<Request> msgs;  // empty for direct responses
      bool is_direct = false;
      Response direct;
    };
    std::vector<ReadyItem> ready;
    for (const auto& item : items) {
      const Request& req = item.first;
      bool from_cache = item.second;
      const std::string key = ps_key(req.psid, req.name);
      int64_t n = 1;
      for (int64_t d : req.shape) n *= d;
      elem_cache_[key] = n;
      group_ids_[key] = req.group_id;
      if (req.type == REQ_JOIN) {
        joined_.insert(rank);
        last_joined_ = rank;
        if (int(joined_.size()) == size_) {
          ReadyItem ri;
          ri.is_direct = true;
          ri.direct.type = RESP_JOIN;
          ri.direct.names = {"join"};
          ri.direct.last_joined = last_joined_;
          ready.push_back(std::move(ri));
          joined_.clear();
        } else {
          std::vector<std::pair<std::string, std::vector<Request>>>
              scanned;
          ScanComplete(&scanned);
          for (auto& kv : scanned) {
            ReadyItem ri;
            ri.key = std::move(kv.first);
            ri.name = kv.second[0].name;
            ri.msgs = std::move(kv.second);
            ready.push_back(std::move(ri));
          }
        }
        continue;
      }
      if (req.type == REQ_BARRIER) {
        int required = RequiredFor(req);
        auto& arrived = barriers_[key];
        arrived.insert(rank);
        if (int(arrived.size()) >= required) {
          barriers_.erase(key);
          ReadyItem ri;
          ri.is_direct = true;
          ri.direct.type = RESP_BARRIER;
          ri.direct.names = {req.name};
          ri.direct.psid = req.psid;
          ri.direct.psr = req.psr;
          ready.push_back(std::move(ri));
        }
        continue;
      }
      if (!from_cache) {
        bit_only_[key] = false;
        if (cache_.has(key)) {
          // Signature changed on some rank (or worker-side
          // invalidation): renegotiate so a stale response can never
          // serve.
          int32_t bit = cache_.evict_name(key);
          if (bit >= 0) pending_evictions_.push_back(bit);
        }
      } else if (!bit_only_.count(key)) {
        bit_only_[key] = true;
      }
      int required = RequiredFor(req);
      if (!first_seen_.count(key))
        first_seen_[key] = std::chrono::steady_clock::now();
      auto& msgs = table_[key];
      msgs.push_back(req);
      if (int(msgs.size()) + JoinedCountFor(req) >= required) {
        ReadyItem ri;
        ri.name = req.name;
        ri.key = key;
        ri.msgs = std::move(msgs);
        table_.erase(key);
        first_seen_.erase(key);
        ready.push_back(std::move(ri));
      }
    }
    if (ready.empty()) {
      FlushEvictionsLocked();
      return;
    }

    // Group atomicity: a grouped submission must not straddle the CB
    // and RS frames — if any member renegotiates this round, every
    // member of that group is demoted to the full path
    // (controller_net.py full_groups).
    std::set<int32_t> full_gids;
    for (const auto& ri : ready) {
      if (ri.is_direct) continue;
      auto bo = bit_only_.find(ri.key);
      bool bit_only = bo != bit_only_.end() && bo->second;
      if (!(bit_only && cache_.get(ri.key) != nullptr)) {
        auto git = group_ids_.find(ri.key);
        if (git != group_ids_.end() && git->second >= 0)
          full_gids.insert(git->second);
      }
    }

    // Partition: pure-bit rounds ride the compact CB frame.
    std::vector<Response> hit_responses;
    std::vector<Response> full_responses;
    std::map<std::string, Sig> sig_by_name;
    for (auto& ri : ready) {
      if (ri.is_direct) {
        full_responses.push_back(std::move(ri.direct));
        continue;
      }
      const std::string& name = ri.name;
      const std::string& key = ri.key;
      bool bit_only = false;
      auto bo = bit_only_.find(key);
      if (bo != bit_only_.end()) {
        bit_only = bo->second;
        bit_only_.erase(bo);
      }
      CoordCache::Entry* ent = cache_.get(key);
      int32_t gid = -1;
      auto git = group_ids_.find(key);
      if (git != group_ids_.end()) gid = git->second;
      // While any rank is joined, cached responses are stale for it
      // (renegotiation substitutes zeros for joined ranks) — bypass
      // the fast path entirely.
      if (bit_only && ent != nullptr && joined_.empty() &&
          (gid < 0 || !full_gids.count(gid))) {
        hit_responses.push_back(ent->resp);
        continue;
      }
      Response resp = construct_response(name, ri.msgs, size_);
      sig_by_name[key] = make_sig(ri.msgs[0]);
      full_responses.push_back(std::move(resp));
      cache_.clear_tombstones_for(key);
    }

    int64_t nbytes = 0;
    if (!hit_responses.empty()) {
      auto fused_hits = Fuse(hit_responses);
      std::vector<std::vector<int32_t>> batches;
      for (const auto& fr : fused_hits) {
        std::vector<int32_t> batch;
        for (const auto& n : fr.names) {
          CoordCache::Entry* e = cache_.get(ps_key(fr.psid, n));
          batch.push_back(e ? e->bit : -1);
        }
        batches.push_back(std::move(batch));
        nbytes += ResponseBytes(fr);
      }
      BroadcastFrameLocked("CB", pack_bit_batches(batches));
      fast_rounds_.fetch_add(1);
    }
    if (!full_responses.empty()) {
      auto fused = Fuse(std::move(full_responses));
      if (cache_.enabled()) AssignCacheBits(&fused, sig_by_name);
      FlushEvictionsLocked();
      BroadcastLocked(fused);
      full_rounds_.fetch_add(1);
      for (const auto& r : fused) nbytes += ResponseBytes(r);
    } else {
      FlushEvictionsLocked();
    }
    rounds_.fetch_add(1);
    bytes_.fetch_add(nbytes);
    // Per-round history for the autotuner (written under mu_; the
    // host poll thread is the single reader).
    round_bytes_[round_w_.load(std::memory_order_relaxed) % kRoundRing] =
        nbytes;
    round_w_.fetch_add(1, std::memory_order_release);
  }

  // Slice a fused response into per-tensor responses (mirrors
  // response_cache.py split_response) and seed the cache, stamping the
  // assigned bits onto the wire.
  void AssignCacheBits(std::vector<Response>* fused,
                       const std::map<std::string, Sig>& sig_by_name) {
    std::set<std::string> pending;
    for (const auto& kv : table_) pending.insert(kv.first);
    for (auto& resp : *fused) {
      if (!kCacheable.count(resp.type) || !resp.error.empty()) continue;
      size_t group = resp.psr.empty() ? size_t(size_) : resp.psr.size();
      size_t per_sizes = 0;
      if (resp.type == RESP_ALLGATHER && group > 0 &&
          resp.sizes.size() == group * resp.names.size())
        per_sizes = group;
      resp.cache_bits.clear();
      for (size_t i = 0; i < resp.names.size(); ++i) {
        const std::string key = ps_key(resp.psid, resp.names[i]);
        auto sit = sig_by_name.find(key);
        if (sit == sig_by_name.end()) {
          resp.cache_bits.push_back(-1);
          continue;
        }
        Response part;
        part.type = resp.type;
        part.dtype = resp.dtype;
        part.prescale = resp.prescale;
        part.postscale = resp.postscale;
        part.psid = resp.psid;
        part.root = resp.root;
        part.op = resp.op;
        part.names = {resp.names[i]};
        if (per_sizes)
          part.sizes.assign(resp.sizes.begin() + i * per_sizes,
                            resp.sizes.begin() + (i + 1) * per_sizes);
        else
          part.sizes = resp.sizes;
        if (i < resp.shapes.size()) part.shapes = {resp.shapes[i]};
        part.psr = resp.psr;
        auto git = group_ids_.find(key);
        int32_t gid = git == group_ids_.end() ? -1 : git->second;
        int32_t bit = cache_.insert(key, part, sit->second,
                                    gid, pending, &pending_evictions_);
        resp.cache_bits.push_back(bit);
      }
    }
  }

  // Pre-formation requests never enter table_, so StallReport is
  // blind to a rank that dies before connecting — attribute that
  // stall here and, past the shutdown threshold, fail the buffered
  // collectives (mirrors controller_net.py _check_formation_stall).
  void CheckFormationStall() {
    std::lock_guard<std::mutex> g(mu_);
    if (formed_ || pre_formed_.empty()) return;
    double age = std::chrono::duration<double>(
        std::chrono::steady_clock::now() - started_at_).count();
    if (age < stall_warn_s_) return;
    std::string miss;
    for (int r = 0; r < size_; ++r)
      if (!conns_.count(r)) miss += std::to_string(r) + ",";
    if (!miss.empty()) miss.pop_back();
    std::fprintf(stderr,
                 "STALL: waiting for ranks [%s] to connect for %.0fs "
                 "(%zu/%d registered, %zu requests buffered)\n",
                 miss.c_str(), age, conns_.size(), size_,
                 pre_formed_.size());
    if (stall_shutdown_s_ > 0 && age >= stall_shutdown_s_) {
      std::vector<PreItem> pre;
      pre.swap(pre_formed_);
      std::vector<Response> errs;
      for (auto& p : pre) {
        for (auto& rq : p.reqs) {
          Response r;
          r.type = RESP_ERROR;
          r.names = {rq.name};
          r.psid = rq.psid;
          r.error = "ranks [" + miss + "] never connected within " +
                    std::to_string(int(stall_shutdown_s_)) + "s";
          errs.push_back(std::move(r));
        }
      }
      if (!errs.empty()) BroadcastLocked(errs);
    }
  }

  void StallLoop() {
    double interval = stall_warn_s_ / 2.0;
    if (interval > 10.0) interval = 10.0;
    if (interval < 0.25) interval = 0.25;
    std::unique_lock<std::mutex> lk(stall_mu_);
    while (!stop_.load()) {
      stall_cv_.wait_for(lk, std::chrono::duration<double>(interval));
      if (stop_.load()) return;
      CheckFormationStall();
      auto report = StallReport();
      if (!report.empty()) std::fprintf(stderr, "%s", report.c_str());
      if (stall_shutdown_s_ <= 0) continue;
      // Fail collectives stalled past the shutdown threshold.
      auto now = std::chrono::steady_clock::now();
      std::lock_guard<std::mutex> g(mu_);
      std::vector<std::string> doomed;
      for (const auto& kv : table_) {
        auto ts = first_seen_.find(kv.first);
        if (ts == first_seen_.end()) continue;
        double age =
            std::chrono::duration<double>(now - ts->second).count();
        if (age >= stall_shutdown_s_) doomed.push_back(kv.first);
      }
      for (const auto& key : doomed) {
        table_.erase(key);
        first_seen_.erase(key);
        bit_only_.erase(key);
        Response r;
        r.type = RESP_ERROR;
        r.names = {pure_name(key)};
        r.psid = key_psid(key);  // workers pop entries by (name, psid)
        r.error = "collective " + pure_name(key) +
                  " stalled past the shutdown threshold";
        BroadcastLocked({r});
      }
    }
  }

  void OnRankLost(int rank, bool clean) {
    if (!elastic_) return;
    std::lock_guard<std::mutex> g(mu_);
    auto it = conns_.find(rank);
    if (it != conns_.end()) {
      ::close(it->second);
      conns_.erase(it);
    }
    broken_ = true;
    std::vector<Response> errs;
    std::string msg = "rank " + std::to_string(rank) +
                      " left the job (" +
                      (clean ? "clean" : "connection lost") +
                      "); membership changed";
    for (auto& kv : table_) {
      Response r;
      r.type = RESP_ERROR;
      r.names = {pure_name(kv.first)};
      r.psid = key_psid(kv.first);
      r.error = msg;
      errs.push_back(std::move(r));
    }
    for (auto& kv : barriers_) {
      Response r;
      r.type = RESP_ERROR;
      r.names = {pure_name(kv.first)};
      r.psid = key_psid(kv.first);
      r.error = msg;
      errs.push_back(std::move(r));
    }
    for (auto& p : pre_formed_) {  // pre-formation buffered submitters
      for (auto& rq : p.reqs) {
        Response r;
        r.type = RESP_ERROR;
        r.names = {rq.name};
        r.psid = rq.psid;
        r.error = msg;
        errs.push_back(std::move(r));
      }
    }
    pre_formed_.clear();
    table_.clear();
    barriers_.clear();
    first_seen_.clear();
    bit_only_.clear();
    if (!errs.empty()) BroadcastLocked(errs);
    // Abort broadcast: workers with no pending eager negotiation
    // (blocked in framework-plane collectives or compute) must learn
    // the membership broke while this coordinator is still up, so
    // they can disconnect their jax client before rank 0 takes the
    // coordination service down (leader loss under an attached
    // client is process-fatal).  Mirrors the Python coordinator.
    BroadcastFrameLocked("AB",
                         std::vector<uint8_t>(msg.begin(), msg.end()));
  }

  int size_;
  std::atomic<int64_t> fusion_threshold_;
  bool elastic_;
  CoordCache cache_;
  double stall_warn_s_;
  double stall_shutdown_s_;
  int listen_fd_ = -1;
  int port_ = 0;
  std::atomic<bool> stop_{false};
  std::thread accept_thread_;
  std::thread stall_thread_;
  std::vector<std::thread> rank_threads_;

  std::mutex mu_;
  // Formation gate: uplink frames buffered until every rank connects
  // (see HandleRequests).
  struct PreItem {
    int rank = -1;
    bool is_hits = false;
    std::vector<Request> reqs;
    std::vector<int32_t> bits;
  };
  bool formed_ = false;
  std::vector<PreItem> pre_formed_;
  std::chrono::steady_clock::time_point started_at_ =
      std::chrono::steady_clock::now();
  std::map<int, int> conns_;                      // rank -> fd
  std::map<std::string, std::vector<Request>> table_;
  std::map<std::string, std::set<int>> barriers_;
  std::map<std::string, int64_t> elem_cache_;
  std::map<std::string, int32_t> group_ids_;
  std::map<std::string, bool> bit_only_;
  std::map<std::string, std::chrono::steady_clock::time_point> first_seen_;
  std::vector<int32_t> pending_evictions_;
  std::set<int> joined_;
  int last_joined_ = -1;
  bool broken_ = false;
  std::mutex departed_mu_;
  std::condition_variable departed_cv_;
  std::mutex stall_mu_;
  std::condition_variable stall_cv_;
  int seen_ = 0;
  int departed_ = 0;
  std::atomic<int64_t> rounds_{0};
  std::atomic<int64_t> bytes_{0};
  std::atomic<int64_t> fast_rounds_{0};
  std::atomic<int64_t> full_rounds_{0};
  static constexpr int kRoundRing = 8192;
  std::vector<int64_t> round_bytes_ = std::vector<int64_t>(kRoundRing);
  std::atomic<int64_t> round_w_{0};
  int64_t round_r_ = 0;  // poll-thread-owned cursor
};

}  // namespace

extern "C" {

void* hvd_coord_create(int size, const char* bind_addr, int port,
                       long long fusion_threshold, int elastic,
                       int allow_ephemeral, int cache_capacity,
                       double stall_warn_s, double stall_shutdown_s) {
  auto* c = new Coordinator(size, bind_addr ? bind_addr : "", port,
                            fusion_threshold, elastic != 0,
                            allow_ephemeral != 0, cache_capacity,
                            stall_warn_s, stall_shutdown_s);
  if (!c->valid()) {
    delete c;
    return nullptr;
  }
  return c;
}

int hvd_coord_port(void* h) {
  return static_cast<Coordinator*>(h)->port();
}

void hvd_coord_set_fusion(void* h, long long v) {
  static_cast<Coordinator*>(h)->set_fusion(v);
}

void hvd_coord_stats(void* h, long long* rounds, long long* bytes) {
  int64_t r, b;
  static_cast<Coordinator*>(h)->stats(&r, &b);
  *rounds = r;
  *bytes = b;
}

void hvd_coord_cache_stats(void* h, long long* fast_rounds,
                           long long* full_rounds) {
  int64_t f, n;
  static_cast<Coordinator*>(h)->cache_stats(&f, &n);
  *fast_rounds = f;
  *full_rounds = n;
}

int hvd_coord_drain_round_bytes(void* h, long long* out, int cap) {
  static_assert(sizeof(long long) == sizeof(int64_t), "ABI");
  return static_cast<Coordinator*>(h)->DrainRoundBytes(
      reinterpret_cast<int64_t*>(out), cap);
}

int hvd_coord_stall_report(void* h, char* buf, int cap) {
  std::string s = static_cast<Coordinator*>(h)->StallReport();
  int n = int(s.size());
  if (n > cap - 1) n = cap - 1;
  if (n < 0) n = 0;
  std::memcpy(buf, s.data(), size_t(n));
  buf[n] = '\0';
  return n;
}

void hvd_coord_counts(void* h, int* seen, int* departed) {
  static_cast<Coordinator*>(h)->DepartureCounts(seen, departed);
}

void hvd_coord_stop(void* h) {
  auto* c = static_cast<Coordinator*>(h);
  c->Stop();
  delete c;
}

}  // extern "C"
