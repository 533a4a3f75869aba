// mxq_runtime: the host-side runtime of mxq_tpu_torch, in C++.
//
//   * bit-packers producing the packfmt.py layout (offline conversion of a
//     checkpoint into the packed artifact without a device)
//   * a continuous-batching scheduler state machine (slot admission,
//     retirement, token accounting) driven by the Python engine loop
//     (serving/engine.py)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libmxq_runtime.so mxq_runtime.cc
// (runtime/native.py does so into mxq_tpu_torch/_build/ on first use).
// ABI: plain C, consumed via ctypes (mxq_tpu_torch/runtime/native.py).

#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Bit packers (layout contract: mxq_tpu_torch/packfmt.py)
// ---------------------------------------------------------------------------

// codes: [K2, N] row-major int8 in [0,3], K2 % 16 == 0.
// out:   [K2/16, N] int32; word r, lane n holds codes[16r + j, n] at bits 2j.
void mxq_pack2b(const int8_t* codes, int64_t k2, int64_t n, int32_t* out) {
  const int64_t rows = k2 / 16;
  for (int64_t r = 0; r < rows; ++r) {
    int32_t* orow = out + r * n;
    std::memset(orow, 0, sizeof(int32_t) * n);
    for (int j = 0; j < 16; ++j) {
      const int8_t* crow = codes + (r * 16 + j) * n;
      const int shift = 2 * j;
      for (int64_t c = 0; c < n; ++c) {
        orow[c] |= (static_cast<int32_t>(crow[c]) & 0x3) << shift;
      }
    }
  }
}

// codes: [K4, N] int8 in [0,15], K4 % 8 == 0. out: [K4/8, N] int32.
void mxq_pack4b(const int8_t* codes, int64_t k4, int64_t n, int32_t* out) {
  const int64_t rows = k4 / 8;
  for (int64_t r = 0; r < rows; ++r) {
    int32_t* orow = out + r * n;
    std::memset(orow, 0, sizeof(int32_t) * n);
    for (int j = 0; j < 8; ++j) {
      const int8_t* crow = codes + (r * 8 + j) * n;
      const int shift = 4 * j;
      for (int64_t c = 0; c < n; ++c) {
        orow[c] |= (static_cast<int32_t>(crow[c]) & 0xF) << shift;
      }
    }
  }
}

// zeros/scales: [G2, N] int8 codes with G2 = 3 * NBP; group order is flat
// along K. out: [NBP, N] int32 with the k-tile word mapping of packfmt.py:
// word (t, r) field i <- group t*48 + 16*i + r.
void mxq_pack_meta(const int8_t* zeros, const int8_t* scales, int64_t g2,
                   int64_t n, int32_t* out) {
  const int64_t nbp = g2 / 3;
  const int64_t n_tiles = nbp / 16;
  for (int64_t t = 0; t < n_tiles; ++t) {
    for (int64_t r = 0; r < 16; ++r) {
      int32_t* orow = out + (t * 16 + r) * n;
      std::memset(orow, 0, sizeof(int32_t) * n);
      for (int i = 0; i < 3; ++i) {
        const int64_t g = t * 48 + 16 * i + r;
        const int8_t* zrow = zeros + g * n;
        const int8_t* srow = scales + g * n;
        for (int64_t c = 0; c < n; ++c) {
          orow[c] |= (static_cast<int32_t>(zrow[c]) & 0x3) << (2 * i);
          orow[c] |= (static_cast<int32_t>(srow[c]) & 0xFF) << (6 + 8 * i);
        }
      }
    }
  }
}

// Unpack (round-trip validation / debugging)
void mxq_unpack2b(const int32_t* words, int64_t rows, int64_t n,
                  int8_t* codes) {
  for (int64_t r = 0; r < rows; ++r) {
    const int32_t* wrow = words + r * n;
    for (int j = 0; j < 16; ++j) {
      int8_t* crow = codes + (r * 16 + j) * n;
      const int shift = 2 * j;
      for (int64_t c = 0; c < n; ++c) {
        crow[c] = static_cast<int8_t>((static_cast<uint32_t>(wrow[c]) >> shift)
                                      & 0x3);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Continuous-batching scheduler
// ---------------------------------------------------------------------------

struct Request {
  int64_t uid;
  int32_t prompt_len;
  int32_t max_new_tokens;
  int32_t eos_token;   // -1 = none
  int32_t generated;   // tokens produced so far
  int32_t last_token;
};

struct Scheduler {
  int32_t num_slots;
  int32_t max_len;
  std::vector<int64_t> slot_uid;    // -1 = free
  std::vector<int32_t> slot_pos;    // next write position
  std::vector<Request> slot_req;
  std::deque<Request> queue;
  int64_t completed = 0;
};

Scheduler* mxq_sched_new(int32_t num_slots, int32_t max_len) {
  auto* s = new Scheduler();
  s->num_slots = num_slots;
  s->max_len = max_len;
  s->slot_uid.assign(num_slots, -1);
  s->slot_pos.assign(num_slots, 0);
  s->slot_req.resize(num_slots);
  return s;
}

void mxq_sched_free(Scheduler* s) { delete s; }

void mxq_sched_submit(Scheduler* s, int64_t uid, int32_t prompt_len,
                      int32_t max_new_tokens, int32_t eos_token) {
  s->queue.push_back(Request{uid, prompt_len, max_new_tokens, eos_token, 0, -1});
}

// Admit queued requests into free slots. Writes up to num_slots admitted
// (slot, uid, prompt_len) triples; returns the count. The caller performs
// the device prefill for each admitted slot and reports the first token via
// mxq_sched_on_token.
int32_t mxq_sched_admit(Scheduler* s, int32_t* slots, int64_t* uids,
                        int32_t* prompt_lens) {
  int32_t count = 0;
  for (int32_t i = 0; i < s->num_slots && !s->queue.empty(); ++i) {
    if (s->slot_uid[i] != -1) continue;
    Request r = s->queue.front();
    s->queue.pop_front();
    s->slot_uid[i] = r.uid;
    s->slot_pos[i] = r.prompt_len;
    s->slot_req[i] = r;
    slots[count] = i;
    uids[count] = r.uid;
    prompt_lens[count] = r.prompt_len;
    ++count;
  }
  return count;
}

// Record one generated token for a slot. Returns 1 if the request finished
// (slot freed), else 0.
int32_t mxq_sched_on_token(Scheduler* s, int32_t slot, int32_t token) {
  Request& r = s->slot_req[slot];
  r.generated += 1;
  r.last_token = token;
  s->slot_pos[slot] += (r.generated > 1) ? 1 : 0;  // first token from prefill
  const bool hit_eos = (r.eos_token >= 0 && token == r.eos_token);
  const bool full = s->slot_pos[slot] >= s->max_len - 1;
  if (r.generated >= r.max_new_tokens || hit_eos || full) {
    s->slot_uid[slot] = -1;
    s->completed += 1;
    return 1;
  }
  return 0;
}

int32_t mxq_sched_active(Scheduler* s, int32_t* slots, int32_t* last_tokens,
                         int32_t* positions) {
  int32_t count = 0;
  for (int32_t i = 0; i < s->num_slots; ++i) {
    if (s->slot_uid[i] == -1) continue;
    slots[count] = i;
    last_tokens[count] = s->slot_req[i].last_token;
    positions[count] = s->slot_pos[i];
    ++count;
  }
  return count;
}

int64_t mxq_sched_completed(Scheduler* s) { return s->completed; }
int32_t mxq_sched_pending(Scheduler* s) {
  return static_cast<int32_t>(s->queue.size());
}

// Cancel a request by uid. Returns the slot it occupied (now freed), -1 if
// it was removed from the queue, or -2 if not found (already finished).
// A cancelled running request does NOT count toward `completed`.
int32_t mxq_sched_cancel(Scheduler* s, int64_t uid) {
  for (int32_t i = 0; i < s->num_slots; ++i) {
    if (s->slot_uid[i] == uid) {
      s->slot_uid[i] = -1;
      return i;
    }
  }
  for (auto it = s->queue.begin(); it != s->queue.end(); ++it) {
    if (it->uid == uid) {
      s->queue.erase(it);
      return -1;
    }
  }
  return -2;
}

}  // extern "C"
